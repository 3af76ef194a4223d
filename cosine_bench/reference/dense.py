"""Plain reference of the Qwen1.5 / Qwen2 decoder (dense FFN).

One forward over one whole sequence, in plain PyTorch: no cache, no
batching, no kernel. It is causal, or follows a given mask and positions
(a draft tree after its context: each node sees the context, its
ancestors and itself, at the context's length plus its depth). It follows the published architecture (Qwen2 in
Hugging Face `transformers`): token embedding; per layer RMSNorm, grouped
query attention with biases on Q, K and V and rotary embeddings
(rotate-half, theta `rope_theta`), a residual, RMSNorm, a SwiGLU FFN, a
residual; a final RMSNorm and the output head (the embedding's
transpose when `tie_word_embeddings`).

Precision is the one the configuration states (its `dtypes`): every
weight product in float32 with TF32 off; the residual stream rounded to
the activation type after each block, and each norm's output cast to it
(the serving program's rounding points, which are the JAX reference's).
This departs from running the published bf16 checkpoint in bf16
throughout, which no configuration here does. A tied head multiplies in
the activation type, as a bf16 checkpoint's head does.

`control` computes in the next precision below a stated one, for the
benchmark's control: "tf32" takes every product's operands rounded to
TF32 (10 bits of mantissa, round half away from zero), the precision a
float32 product has with TF32 on; "fp8" rounds the activations to fp8
(e4m3, each row scaled so that its largest value is e4m3's largest,
448) wherever the configuration rounds them to their 16-bit type.

Parameters are the benchmark's trees (`weights.py`): plain dicts of
tensors under the names of `param_specs`. Nothing here imports the
program or JAX.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def head_dim(cfg: dict) -> int:
    """Head width: `head_dim` where the configuration gives it."""
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def padded_vocab(cfg: dict, multiple: int = 256) -> int:
    """Rows of the embedding table: the vocabulary padded to a multiple
    of 256 (the program's table; the padded rows are never read)."""
    v = cfg["vocab_size"]
    return -(-v // multiple) * multiple


def attention_specs(cfg: dict, prefix: tuple) -> list:
    """(path, shape, init) of one attention block's projections."""
    d, H, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    hd = head_dim(cfg)
    return [(prefix + ("wq",), (d, H * hd), "dense"),
            (prefix + ("wk",), (d, Hkv * hd), "dense"),
            (prefix + ("wv",), (d, Hkv * hd), "dense"),
            (prefix + ("wo",), (H * hd, d), "dense"),
            (prefix + ("bq",), (H * hd,), "bias"),
            (prefix + ("bk",), (Hkv * hd,), "bias"),
            (prefix + ("bv",), (Hkv * hd,), "bias")]


def mlp_specs(d: int, f: int, prefix: tuple) -> list:
    """(path, shape, init) of a SwiGLU FFN of width `f`."""
    return [(prefix + ("wg",), (d, f), "dense"),
            (prefix + ("wu",), (d, f), "dense"),
            (prefix + ("wd",), (f, d), "dense")]


def param_specs(cfg: dict, ffn_specs=None) -> list:
    """(path, shape, init) of every parameter, in the program's layout:
    "embed", "layers"[i]{"ln1", "mixer", "ln2", "ffn"}, "final_norm",
    "head" (untied). `ffn_specs(cfg, prefix)` gives a layer's FFN
    (default: SwiGLU of `intermediate_size`)."""
    d = cfg["hidden_size"]
    ffn_specs = ffn_specs or (lambda c, p: mlp_specs(
        d, c["intermediate_size"], p))
    specs = [(("embed",), (padded_vocab(cfg), d), "embed")]
    for i in range(cfg["num_hidden_layers"]):
        pre = ("layers", i)
        specs.append((pre + ("ln1", "scale"), (d,), "norm"))
        specs += attention_specs(cfg, pre + ("mixer",))
        specs.append((pre + ("ln2", "scale"), (d,), "norm"))
        specs += ffn_specs(cfg, pre + ("ffn",))
    specs.append((("final_norm", "scale"), (d,), "norm"))
    if not cfg.get("tie_word_embeddings", False):
        specs.append((("head",), (d, padded_vocab(cfg)), "embed"))
    return specs


class Numerics:
    """Where the forward rounds: `act(x)` rounds activations to the
    stated type (or, under the "fp8" control, to scaled fp8);
    `tf32` rounds every product's operands to TF32."""

    def __init__(self, act_dtype, control=None):
        if control not in (None, "tf32", "fp8"):
            raise ValueError(f"unknown control {control!r}")
        self.dtype = act_dtype
        self.tf32 = control == "tf32"
        self.fp8 = control == "fp8"

    def act(self, x):
        if not self.fp8:
            return x.to(self.dtype)
        x = x.float()
        s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits, half away from
    zero on the magnitude)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, num: Numerics) -> torch.Tensor:
    """float32 product a @ b (TF32 operands under the "tf32" control)."""
    a, b = a.float(), b.float()
    if num.tf32:
        a, b = tf32(a), tf32(b)
    return a @ b


def rms_norm(x, scale, eps, num: Numerics):
    """RMSNorm in float32, rounded as activations."""
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale
    return num.act(y)


def rope(x, positions, theta):
    """Rotary embedding, rotate-half form. x: (T, H, D) float32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, cfg, num: Numerics, pos, allowed):
    """GQA over the whole sequence. h: (T, d); pos: (T,) positions;
    allowed: (T, T) bool, which keys each query sees. Returns (T, d)
    float32."""
    T = h.shape[0]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = head_dim(cfg)
    q = (mm(h, p["wq"], num) + p["bq"]).view(T, H, hd)
    k = (mm(h, p["wk"], num) + p["bk"]).view(T, Hkv, hd)
    v = (mm(h, p["wv"], num) + p["bv"]).view(T, Hkv, hd)
    q = rope(q, pos, cfg["rope_theta"])
    k = rope(k, pos, cfg["rope_theta"])
    g = H // Hkv
    out = torch.empty((T, H, hd), dtype=torch.float32, device=h.device)
    for j in range(Hkv):                # one KV head at a time: fits
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)          # (g, T, hd)
        s = mm(qj, k[:, j].t(), num) * hd ** -0.5          # (g, T, T)
        s = s.masked_fill(~allowed, float("-inf"))
        out[:, j * g:(j + 1) * g] = mm(torch.softmax(s, -1), v[:, j],
                                       num).transpose(0, 1)
    return mm(out.reshape(T, H * hd), p["wo"], num)


def mlp(p, h, num: Numerics):
    """SwiGLU FFN, float32."""
    gate = torch.nn.functional.silu(mm(h, p["wg"], num))
    return mm(gate * mm(h, p["wu"], num), p["wd"], num)


def forward(cfg, params, tokens, out_positions, *, positions=None,
            allowed=None, control=None, ffn=None):
    """Logits (float32, real vocabulary) at `out_positions` of one forward
    over `tokens` (T,): causal, at positions 0 .. T-1, unless `positions`
    (T,) and `allowed` ((T, T) bool: key j is seen by query i) say
    otherwise, as for a draft tree after its context. `ffn(p, h, cfg,
    num)` is a layer's FFN (default: SwiGLU). TF32 is switched off for
    the forward."""
    T = tokens.shape[0]
    if positions is None:
        positions = torch.arange(T, device=tokens.device)
    if allowed is None:
        allowed = torch.ones((T, T), dtype=torch.bool,
                             device=tokens.device).tril()
    act = DTYPES[cfg["dtypes"]["activations"]]
    num = Numerics(act, control)
    eps = cfg["rms_norm_eps"]
    ffn = ffn or (lambda p, h, c, n: mlp(p, h, n))
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = num.act(params["embed"][tokens.long()])
        for lp in params["layers"]:
            h = rms_norm(x, lp["ln1"]["scale"], eps, num)
            x = num.act(x + attention(lp["mixer"], h, cfg, num, positions,
                                      allowed))
            h = rms_norm(x, lp["ln2"]["scale"], eps, num)
            x = num.act(x + ffn(lp["ffn"], h, cfg, num))
        x = rms_norm(x, params["final_norm"]["scale"], eps, num)
        x = x[out_positions]
        V = cfg["vocab_size"]
        if cfg.get("tie_word_embeddings", False):
            emb = params["embed"][:V]
            if act == torch.float32 or num.fp8:
                return mm(x, emb.t(), num)
            return (x @ emb.t().to(act)).float()
        return mm(x, params["head"][:, :V], num)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
