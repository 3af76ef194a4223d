"""Model assembly (port of `repro.models.model`): dense attention, MLA,
SSM and hybrid (SSM + attention) layer plans, cross-attention layers
(VLMs) and encoder-decoders (Whisper).

Parameters and caches are plain dicts of tensors, one entry per layer
(the reference's `lax.scan` over stacked stages is a Python loop here):

  params = {"embed": (Vp, d), "layers": [{"ln1", "mixer", "ln_cross"?,
            "cross"?, "ln2", "ffn"}], "final_norm": {...},
            "head": (d, Vp) unless tied, "pos" (learned positions),
            "encoder": {"layers": [...], "final_norm", "pos"} (enc-dec)}
  cache  = {"layers": [{"self": kv cache | ssm state, "cross"?: kv cache}],
            "lengths": (B,) int32}

An attention layer's "self" cache is a KV cache ({"k", "v", "slot_pos"});
an MLA layer's the same leaves holding its latent c_kv ++ k_pe and c_kv
(one KV head, `attention.make_mla_cache`); an SSM layer's is its
recurrent state ({"ssm", "conv", "pos"}, float32 whatever the cache
dtype, see `models/ssm.py`). With `cfg.mtp` (DeepSeek-V3) the params
also hold the reference's multi-token-prediction subtree under "mtp"
({"proj", "norm_h", "norm_e", "layer"}); serving does not run it.

One `apply()` serves scoring, prefill, decode and speculative
verification (chain or tree), as in the reference; the mode follows from
(cache, seg_mask, write). Caches are updated IN PLACE (the reference
returns new arrays): the slot steps write only the new tokens' rows of
the active slots of the resident pool, which is what the reference's
`_scatter_stage_delta` does after its scan.

The slot steps also run on a paged cache (`init_paged_cache`): the
attention KV of every attention layer lives in a pool of pages, read and
written through a `page_view` block table, while SSM state and `lengths`
stay slot-indexed.

A MoE layer's FFN (`models/moe.py`) routes each token to its top-k
experts; `apply` sums the layers' load-balance losses into its aux
output, as the reference does. With `cfg.kv_dtype == "int8"` every KV
cache and page pool stores int8 K/V with an f32 scale per (row, head)
(`models/attention.py`), read in place by the attention kernels.

A cross layer (`cfg.is_cross_layer`, or every decoder layer of an
encoder-decoder) adds a cross-attention sub-block after its mixer; its
"cross" cache holds the projected frontend (VLM) or encoder (Whisper)
states, written by a forward given `frontend` and read by the others.
Its capacity is `n_frontend_tokens` (`encoder_seq` for enc-dec), it is
never int8 and it stays slot-indexed on a paged cache. Serving passes no
frontend, as in the reference, so the engine's cross rows stay empty and
every cross read gives 0.

MLA has no int8 KV layout: `kv_dtype="int8"` with MLA raises ValueError
where a cache is made, as the reference.

`lm_loss` is the reference's training loss (next-token cross-entropy,
the MoE aux and DeepSeek-V3's MTP term); a cache-less forward under
autograd differentiates through kernel 1's forward on the card
(`models/attention.py::blocked_attention`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import quantize
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       mlp_params, norm_params)


# ====================================================== layer plan

@dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "mla" | "ssm"
    cross: bool         # has a cross-attention sub-block
    ffn: str            # "dense" | "moe" | "none"


def _spec_for(cfg: ModelConfig, idx: int) -> LayerSpec:
    kind = cfg.layer_kind(idx)
    if kind == "ssm":
        mixer = "ssm"
    elif cfg.attention == "mla":
        mixer = "mla"
    else:
        mixer = "attn"
    if cfg.family == "ssm":
        ffn = "none" if cfg.d_ff == 0 else "dense"
    elif cfg.is_moe_layer(idx):
        ffn = "moe"
    else:
        ffn = "dense"
    cross = cfg.is_cross_layer(idx) or cfg.is_encdec
    return LayerSpec(mixer=mixer, cross=cross, ffn=ffn)


def _compress(specs: list) -> list:
    """Greedy max-coverage run-length stage compression.

    Returns [(pattern tuple, repeats), ...] with sum(len(p)*r) == len(specs).
    """
    stages = []
    i = 0
    n = len(specs)
    while i < n:
        best_p, best_k = 1, 1
        for p in range(1, (n - i) // 2 + 1):
            k = 1
            while specs[i + k * p: i + (k + 1) * p] == specs[i: i + p]:
                k += 1
            if k > 1 and (p * k > best_p * best_k
                          or (p * k == best_p * best_k and p < best_p)):
                best_p, best_k = p, k
        if best_k == 1:  # no repetition: take the longest non-repeating run
            best_p = n - i
        stages.append((tuple(specs[i: i + best_p]), best_k))
        i += best_p * best_k
    return stages


def layer_plan(cfg: ModelConfig) -> list:
    """The reference's stage plan [(pattern, repeats), ...]; the port
    runs layer by layer but keeps the plan to read the reference's
    stacked parameter and cache layout (`models/convert.py`)."""
    return _compress([_spec_for(cfg, i) for i in range(cfg.n_layers)])


def layer_specs(cfg: ModelConfig) -> list:
    """Per-layer specs, in layer order."""
    return [_spec_for(cfg, i) for i in range(cfg.n_layers)]


#: an encoder layer: bidirectional attention (no rope, no cache), no
#: cross block, a dense FFN
ENCODER_SPEC = LayerSpec(mixer="attn", cross=False, ffn="dense")


def effective_window(cfg: ModelConfig) -> int:
    if cfg.attention == "swa" and cfg.sliding_window:
        return cfg.sliding_window
    if cfg.long_context == "swa":
        return cfg.long_context_window
    return 0


# ====================================================== params

def _generator(seed_or_gen, device) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    # (a meta tensor draws nothing: any generator will do)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(int(seed_or_gen))
    return gen


def _layer_params(gen, spec: LayerSpec, cfg: ModelConfig, dev):
    if spec.mixer == "ssm":
        mixer = ssm_mod.ssm_params(gen, cfg, dev)
    elif spec.mixer == "mla":
        mixer = attn.mla_params(gen, cfg, dev)
    else:
        mixer = attn.gqa_params(gen, cfg, dev)
    p = {"ln1": norm_params(cfg, cfg.d_model, dev), "mixer": mixer}
    if spec.cross:
        p["ln_cross"] = norm_params(cfg, cfg.d_model, dev)
        p["cross"] = attn.gqa_params(gen, cfg, dev)
    if spec.ffn != "none":
        p["ln2"] = norm_params(cfg, cfg.d_model, dev)
        p["ffn"] = (moe_mod.moe_params(gen, cfg, cfg.moe, dev)
                    if spec.ffn == "moe" else
                    mlp_params(gen, cfg, cfg.d_model, cfg.d_ff, dev))
    return p


def init_params(cfg: ModelConfig, seed=0, device=None):
    """Random parameters (f32) drawn from `seed` (an int or a
    torch.Generator on `device`). Runs on CUDA unless device="cpu"."""
    dev = resolve_device(device)
    specs = layer_specs(cfg)
    gen = _generator(seed, dev)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dev)}
    params["layers"] = [_layer_params(gen, spec, cfg, dev) for spec in specs]
    params["final_norm"] = norm_params(cfg, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab), dev)
    if cfg.pos_embed == "learned":
        params["pos"] = embed_init(gen, (cfg.max_position, cfg.d_model), dev)
    if cfg.is_encdec:
        # the Whisper-style encoder (frontend embeddings in, states out)
        params["encoder"] = {
            "layers": [_layer_params(gen, ENCODER_SPEC, cfg, dev)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": norm_params(cfg, cfg.d_model, dev),
            "pos": embed_init(gen, (max(cfg.encoder_seq, 1), cfg.d_model),
                              dev),
        }
    if cfg.mtp:
        # DeepSeek-V3's depth-1 multi-token-prediction module, built as
        # the reference builds it (trained, never served)
        spec = LayerSpec(mixer="mla" if cfg.attention == "mla" else "attn",
                         cross=False, ffn="dense")
        params["mtp"] = {
            "proj": embed_init(gen, (2 * cfg.d_model, cfg.d_model), dev),
            "norm_h": norm_params(cfg, cfg.d_model, dev),
            "norm_e": norm_params(cfg, cfg.d_model, dev),
            "layer": _layer_params(gen, spec, cfg, dev),
        }
    return params


# ====================================================== caches

def _reject_mla_int8(cfg: ModelConfig):
    """MLA caches store the *latent* KV (compressed projections consumed
    by einsum up-projections), which has no per-head int8 layout yet —
    fail at construction rather than silently keeping a bf16 pool."""
    if cfg.kv_dtype == "int8":
        raise ValueError(
            "kv_dtype='int8' is not supported with attention='mla': the "
            "latent KV cache has no quantized layout (use GQA, or "
            "kv_dtype='bf16' for MLA models)")


def _kv_pool(spec: LayerSpec, cfg: ModelConfig, rows: int, cols: int, dt,
             dev):
    """An attention or MLA layer's KV cache of `rows` x `cols` (slots x
    capacity, or pages x page size)."""
    if spec.mixer == "mla":
        _reject_mla_int8(cfg)
        return attn.make_mla_cache(rows, cols, cfg, dt, device=dev)
    hd = cfg.resolved_head_dim
    return attn.make_kv_cache(rows, cols, cfg.n_kv_heads, hd, hd, dt,
                              quantized=cfg.kv_dtype == "int8", device=dev)


def cross_len(cfg: ModelConfig) -> int:
    """Rows of a cross cache: the frontend's tokens, or the encoder's
    states for an encoder-decoder."""
    return cfg.encoder_seq if cfg.is_encdec else cfg.n_frontend_tokens


def _cross_cache(cfg: ModelConfig, batch: int, dt, dev):
    """A cross layer's slot-indexed cache: `cross_len` rows (at least
    one), the cache dtype, never int8 (the reference's)."""
    hd = cfg.resolved_head_dim
    return attn.make_kv_cache(batch, max(cross_len(cfg), 1), cfg.n_kv_heads,
                              hd, hd, dt, device=dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Decode/prefill cache: a KV cache per attention layer (int8 K/V
    with f32 scales when cfg.kv_dtype == "int8", whatever `dtype`), a
    latent cache per MLA layer, an SSM state (float32) per SSM layer, a
    cross cache per cross layer, plus `lengths`."""
    dev = resolve_device(device)
    window = effective_window(cfg)
    cap = attn.cache_capacity(cfg, max_len, window)
    dt = torch_dtype(dtype)
    layers = []
    for spec in layer_specs(cfg):
        layer = {"self": ssm_mod.make_ssm_state(batch, cfg, device=dev)
                 if spec.mixer == "ssm" else
                 _kv_pool(spec, cfg, batch, cap, dt, dev)}
        if spec.cross:
            layer["cross"] = _cross_cache(cfg, batch, dt, dev)
        layers.append(layer)
    return {"layers": layers,
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev)}


def _map_cache(cache, fn):
    return [{key: {f: fn(t) for f, t in sub.items()}
             for key, sub in layer.items()} for layer in cache["layers"]]


# ====================================================== slotted caches
#
# Continuous batching: one device-resident cache whose batch axis is a
# pool of request slots. The slot steps pass slot_idx down to attention,
# which writes the new tokens' rows of the active slots in place and reads
# the active rows through slot_idx. gather_slots makes the speculative
# snapshots (decode-and-discard rollback); scatter_slots/reset_slots reset
# a slot on admission.

def gather_slots(cache, slot_idx):
    """Compact copy of the slots `slot_idx` (B,), shaped like a batch
    cache, so every step function runs on it unchanged."""
    idx = slot_idx.long()
    return {"layers": _map_cache(cache, lambda t: t.index_select(0, idx)),
            "lengths": cache["lengths"].index_select(0, idx)}


def scatter_slots(cache, sub, slot_idx):
    """Write sub-cache rows back into their slots, in place. Duplicate
    indices (scratch padding) resolve arbitrarily."""
    idx = slot_idx.long()
    for layer, sub_layer in zip(cache["layers"], sub["layers"]):
        for key, c in layer.items():
            for f, t in c.items():
                t[idx] = sub_layer[key][f]
    cache["lengths"][idx] = sub["lengths"]
    return cache


def reset_slots(cache, slot_idx):
    """Empty the slots `slot_idx` in place (zero K/V and SSM state,
    slot_pos -1, length 0): what scattering a pristine cache into them
    does."""
    idx = slot_idx.long()
    for layer in cache["layers"]:
        for c in layer.values():
            for f, t in c.items():
                t[idx] = -1 if f == "slot_pos" else 0
    cache["lengths"][idx] = 0
    return cache


def concat_slots(cache, extra):
    """Append `extra`'s slots after `cache`'s (capacity growth)."""
    layers = [{key: {f: torch.cat([t, e[key][f]], dim=0)
                     for f, t in sub.items()}
               for key, sub in layer.items()}
              for layer, e in zip(cache["layers"], extra["layers"])]
    return {"layers": layers,
            "lengths": torch.cat([cache["lengths"], extra["lengths"]])}


def slot_decode_step(params, cfg: ModelConfig, tokens, cache, slot_idx,
                     frontend=None, page_view=None):
    """One decode step resident in the slotted cache. tokens: (B, 1);
    slot_idx: (B,). Rows mapped to the scratch slot are compute padding."""
    positions = cache["lengths"][slot_idx.long()][:, None]
    return apply(params, cfg, tokens, positions, cache=cache,
                 frontend=frontend, write=True, slot_idx=slot_idx,
                 page_view=page_view)


def slot_extend(params, cfg: ModelConfig, tokens, cache, slot_idx,
                frontend=None, token_mask=None, page_view=None):
    """Commit a (B, G) chain of tokens into the slotted cache in place.

    token_mask: optional (B, G) bool — True for real tokens, False for a
    suffix of shape padding: written with slot_pos = -1, and `lengths`
    advances by the real-token count only."""
    G = tokens.shape[1]
    positions = (cache["lengths"][slot_idx.long()][:, None]
                 + torch.arange(G, dtype=torch.int32, device=tokens.device))
    return apply(params, cfg, tokens, positions, cache=cache,
                 frontend=frontend, write=True, slot_idx=slot_idx,
                 token_mask=token_mask, page_view=page_view)


def slot_verify_chunk(params, cfg: ModelConfig, tokens, cache, slot_idx,
                      rel_pos, seg_mask, page_view=None):
    """Tree/chain verification against the slotted cache (no commit).
    rel_pos: (B, G) node depths relative to each slot's length."""
    positions = cache["lengths"][slot_idx.long()][:, None] + rel_pos
    logits, _, _ = apply(params, cfg, tokens, positions, cache=cache,
                         seg_mask=seg_mask, write=False, slot_idx=slot_idx,
                         page_view=page_view)
    return logits


# ====================================================== paged caches
#
# Paged slot caches: the same structure as the slotted cache, except that
# each attention layer's "self" cache is a page pool with leading
# (n_pages, page_size) instead of per-slot reserved rows. A request owns
# an ordered list of physical pages (its block table, kept on the host by
# the runner's manager); the slot steps read and write through a
# (B, n_view) `page_view` built from the block tables. SSM state, cross
# caches and `lengths` stay slot-indexed: they are O(1) per request
# already. The helpers take `cfg`, as the reference's do, because only
# the layer plan says which "self" caches are pools.

def _pooled(cfg: ModelConfig, cache):
    """(whether its "self" cache is a page pool, layer cache) for every
    layer; every other leaf of a layer ("cross", an SSM state) is
    slot-indexed."""
    return [(spec.mixer != "ssm", layer)
            for spec, layer in zip(layer_specs(cfg), cache["layers"])]


def _slot_subs(cfg: ModelConfig, cache):
    """(layer, key) of every slot-indexed sub-cache of a paged cache: SSM
    states and cross caches."""
    return [(layer, key) for pooled, layer in _pooled(cfg, cache)
            for key in layer if not (pooled and key == "self")]


def init_slot_leaves(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    """The slot-indexed leaves of a paged cache for `batch` fresh slots:
    an SSM state per SSM layer, a cross cache per cross layer (in
    `dtype`) and `lengths`; a pooled layer holds no "self" here. What
    `concat_slots_paged` appends on slot growth."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    layers = []
    for spec in layer_specs(cfg):
        layer = ({"self": ssm_mod.make_ssm_state(batch, cfg, device=dev)}
                 if spec.mixer == "ssm" else {})
        if spec.cross:
            layer["cross"] = _cross_cache(cfg, batch, dt, dev)
        layers.append(layer)
    return {"layers": layers,
            "lengths": torch.zeros(batch, dtype=torch.int32, device=dev)}


def init_paged_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                     page_size: int = 64, n_pages: int = 16, device=None):
    """Paged decode cache: attention KV in page pools, SSM state, cross
    caches and `lengths` for `batch` slots. There is no per-slot max_len:
    the attention capacity of a request is whatever its block table
    maps."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    cache = init_slot_leaves(cfg, batch, dtype=dt, device=dev)
    # a pool is a slot cache of n_pages "slots" of page_size rows each
    cache["layers"] = [
        layer if spec.mixer == "ssm" else
        {"self": _kv_pool(spec, cfg, n_pages, page_size, dt, dev), **layer}
        for spec, layer in zip(layer_specs(cfg), cache["layers"])]
    return cache


def paged_pool_shape(cfg: ModelConfig, cache):
    """(n_pages, page_size) of the page pools, or None without attention."""
    for pooled, layer in _pooled(cfg, cache):
        if pooled:
            return tuple(layer["self"]["slot_pos"].shape)
    return None


def gather_paged_slots(cfg: ModelConfig, cache, slot_idx, page_view):
    """A plain batch cache copied from a paged pool (speculative
    snapshots): each attention layer's view pages gathered into
    (B, n_view * ps, ...), the layout of `gather_slots` with capacity
    n_view * ps, and every slot-indexed leaf (SSM state, cross cache) at
    rows `slot_idx`, so drafting, rollback and `extend` run on it
    unchanged. Unmapped view entries are NULL pages (slot_pos -1,
    masked)."""
    idx = slot_idx.long()
    layers = []
    for pooled, layer in _pooled(cfg, cache):
        layers.append({
            key: (attn.take_rows(sub, None, page_view)
                  if pooled and key == "self" else
                  {f: t.index_select(0, idx) for f, t in sub.items()})
            for key, sub in layer.items()})
    return {"layers": layers,
            "lengths": cache["lengths"].index_select(0, idx)}


def reset_pages(cfg: ModelConfig, cache, page_ids):
    """Mark physical pages empty (slot_pos = -1) in every pool, in place.
    K/V payloads stay as they are: masking is always against slot_pos."""
    idx = page_ids.long()
    for pooled, layer in _pooled(cfg, cache):
        if pooled:
            layer["self"]["slot_pos"][idx] = -1
    return cache


def reset_slot_state(cfg: ModelConfig, cache, slot_idx):
    """Reset the slot-indexed leaves of a paged cache on (re-)admission,
    in place: SSM state, conv and pos zeroed, cross rows emptied
    (slot_pos -1), `lengths` zeroed (the pools are recycled by
    `reset_pages`)."""
    idx = slot_idx.long()
    for layer, key in _slot_subs(cfg, cache):
        if key == "cross":
            layer[key]["slot_pos"][idx] = -1
        else:
            for t in layer[key].values():
                t[idx] = 0
    cache["lengths"][idx] = 0
    return cache


def concat_slots_paged(cfg: ModelConfig, cache, extra):
    """Slot-capacity growth: `extra`'s slot-indexed leaves (SSM state,
    cross caches, `lengths`; `init_slot_leaves` or a paged cache) are
    appended; the shared page pools stay (their growth is `grow_pages`).
    The layer list and dicts are the argument's, updated, as
    `grow_pages` keeps them."""
    for (layer, key), (e, _) in zip(_slot_subs(cfg, cache),
                                    _slot_subs(cfg, extra)):
        layer[key] = {f: torch.cat([t, e[key][f]], dim=0)
                      for f, t in layer[key].items()}
    return {"layers": cache["layers"],
            "lengths": torch.cat([cache["lengths"], extra["lengths"]])}


def grow_pages(cfg: ModelConfig, cache, extra_pages: int):
    """Append `extra_pages` empty pages to every pool. The pools are new
    tensors, put into the same layer dicts, so no holder of the cache
    keeps a reference to the old ones."""
    for pooled, layer in _pooled(cfg, cache):
        if not pooled:
            continue
        pool = layer["self"]
        for f, t in pool.items():
            pad = torch.full((extra_pages,) + tuple(t.shape[1:]),
                             -1 if f == "slot_pos" else 0, dtype=t.dtype,
                             device=t.device)
            pool[f] = torch.cat([t, pad], dim=0)
    return cache


# ====================================================== apply

def _apply_layer(spec: LayerSpec, p, cache, x, positions, cfg: ModelConfig,
                 *, seg_mask, write, kv_src=None, causal=True, slot_idx=None,
                 token_mask=None, page_view=None):
    """One layer: mixer, the cross sub-block (cross layers), the FFN,
    each a residual rounded to x's dtype. `causal=False` is an encoder
    layer (bidirectional attention, no cache)."""
    h = apply_norm(p["ln1"], x, cfg)
    self_cache = cache["self"] if cache is not None else None
    if not causal:
        out = _bidir_attention(p["mixer"], cfg, h)
    elif spec.mixer == "ssm":
        # a recurrence sees no seg_mask (chain-only verification) and
        # keeps its state slot-indexed on a paged cache too
        out, _ = ssm_mod.ssm_mixer(p["mixer"], cfg, h, state=self_cache,
                                   slot_idx=slot_idx, write=write,
                                   token_mask=token_mask)
    else:
        mixer = (attn.mla_attention if spec.mixer == "mla"
                 else attn.gqa_attention)
        out, _ = mixer(
            p["mixer"], cfg, h, positions, cache=self_cache,
            seg_mask=seg_mask, window=effective_window(cfg),
            slot_idx=slot_idx, write=write, token_mask=token_mask,
            page_view=page_view)
    # the reference rounds the residual stream to cfg.dtype after a block
    x = (x + out).to(x.dtype)
    if spec.cross:
        # given states (kv_src) the block projects them and writes its
        # cross cache; else it reads that cache
        h = apply_norm(p["ln_cross"], x, cfg)
        out, _ = attn.cross_attention(
            p["cross"], cfg, h, kv_src=kv_src,
            cache=cache.get("cross") if cache is not None else None,
            slot_idx=slot_idx, write=write)
        x = (x + out).to(x.dtype)
    aux = None
    if spec.ffn != "none":
        h = apply_norm(p["ln2"], x, cfg)
        if spec.ffn == "moe":
            out, aux = moe_mod.apply_moe(p["ffn"], h, cfg, cfg.moe)
        else:
            out = apply_mlp(p["ffn"], h, cfg)
        x = (x + out).to(x.dtype)
    return x, aux


def _bidir_attention(p, cfg: ModelConfig, h):
    """Encoder self-attention: bidirectional, no rope (the learned
    positions are already added), no window, no cache; on CUDA kernel 1
    with causal=False and T = S."""
    B, T, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = quantize.qdot(h, p["wq"])
    k = quantize.qdot(h, p["wk"])
    v = quantize.qdot(h, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = torch.arange(T, dtype=torch.int32, device=h.device).expand(B, T)
    out = attn.blocked_attention(
        q.reshape(B, T, hkv, hq // hkv, hd), k.reshape(B, T, hkv, hd),
        v.reshape(B, T, hkv, hd), pos, pos, scale=hd ** -0.5, causal=False)
    return quantize.qdot(out.reshape(B, T, hq * hd), p["wo"])


def _encode(params, cfg: ModelConfig, frontend):
    """Whisper encoder: frontend embeddings (B, S, d) -> encoder states
    (learned positions added, promoting as the reference does)."""
    enc = params["encoder"]
    x = frontend + enc["pos"][: frontend.shape[1]]
    for lp in enc["layers"]:
        x, _ = _apply_layer(ENCODER_SPEC, lp, None, x, None, cfg,
                            seg_mask=None, write=False, causal=False)
    return apply_norm(enc["final_norm"], x, cfg)


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = quantize.tied_logits(params["embed"], x).float()
    else:
        logits = quantize.qdot(x, params["head"]).float()
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = -1e30
    return logits


def apply(params, cfg: ModelConfig, tokens, positions=None, cache=None,
          frontend=None, seg_mask=None, write=True, slot_idx=None,
          token_mask=None, page_view=None, remat=False,
          return_hidden=False):
    """Unified forward.

    tokens:    (B, T) int
    positions: (B, T) absolute positions (default arange)
    cache:     None (self-contained) or a dict from init_cache
    seg_mask:  (B, T, T) intra-segment mask (tree verification)
    write:     commit new KV and SSM state into the cache (in place)
    slot_idx:  (B,) — `cache` is a resident slot pool; row b of tokens
               lives in pool slot slot_idx[b]
    frontend:  (B, S, d) frontend embeddings: a VLM's projected image
               patches, an encoder-decoder's audio frames (encoded
               first); the cross layers attend over them and write their
               cross caches. Without it they read those caches.
    token_mask: (B, T) bool — real tokens True, suffix padding False
               (slot path only)
    page_view: (B, n_view) int32 — the cache's attention KV is paged
               (`init_paged_cache`): entry [b, i] is the physical page of
               request b's logical page i (NULL for unmapped entries).
               Requires slot_idx.
    remat:     recompute each layer in the backward pass instead of
               keeping its activations (`torch.utils.checkpoint`, as the
               reference's `jax.checkpoint` of each stage body)
    Returns (logits (B,T,Vp) f32, cache, aux_loss) [+ the final-norm
    hidden states with `return_hidden`]; the returned cache is the
    argument, updated in place."""
    if (token_mask is not None or page_view is not None) and slot_idx is None:
        raise ValueError("token_mask and page_view require the slot path")
    specs = layer_specs(cfg)
    B, T = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev).expand(B, T)
    dtype = torch_dtype(cfg.dtype)
    x = quantize.embed_lookup(params["embed"], tokens, dtype)
    if cfg.pos_embed == "learned":
        x = x + params["pos"][positions.long()].to(dtype)
    kv_src = None
    if frontend is not None:
        if cfg.is_encdec:
            kv_src = _encode(params, cfg, frontend.to(dtype))
        elif cfg.cross_attn_period:
            kv_src = frontend.to(dtype)

    layer_caches = cache["layers"] if cache is not None else [None] * len(specs)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    layer = _apply_layer
    if remat:
        layer = functools.partial(torch.utils.checkpoint.checkpoint,
                                  _apply_layer, use_reentrant=False)
    for spec, lp, lc in zip(specs, params["layers"], layer_caches):
        x, aux = layer(spec, lp, lc, x, positions, cfg, seg_mask=seg_mask,
                       write=write, kv_src=kv_src, slot_idx=slot_idx,
                       token_mask=token_mask, page_view=page_view)
        if aux is not None:
            aux_total = aux_total + aux

    x = apply_norm(params["final_norm"], x, cfg)
    logits = _logits(params, cfg, x)

    if cache is not None and write:
        lengths = cache["lengths"]
        if slot_idx is None:
            cache["lengths"] = torch.maximum(
                lengths, (positions[:, -1] + 1).to(lengths.dtype))
        else:
            # masked suffix tokens never advance the slot length (an
            # all-masked row yields -1 and leaves the length as it is)
            last = (positions[:, -1] if token_mask is None
                    else torch.where(token_mask, positions,
                                     torch.full_like(positions, -1)
                                     ).amax(-1))
            idx = slot_idx.long()
            lengths[idx] = torch.maximum(lengths[idx],
                                         (last + 1).to(lengths.dtype))
    if return_hidden:
        return logits, cache, aux_total, x
    return logits, cache, aux_total


# ====================================================== losses

def _next_token_nll(logits, targets):
    """Mean negative log-likelihood of `targets` (B, T') under `logits`
    (B, T', Vp) f32."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, targets.long()[..., None])[..., 0].mean()


def lm_loss(params, cfg: ModelConfig, tokens, frontend=None, remat=True):
    """Next-token cross-entropy + 0.001 x the MoE aux loss (+ 0.3 x the
    depth-1 MTP loss with `cfg.mtp`): the reference's `lm_loss`.
    tokens: (B, T) int. Returns (total, {"lm", "aux"}), f32 scalars."""
    logits, _, aux, hidden = apply(params, cfg, tokens, frontend=frontend,
                                   remat=remat, return_hidden=True)
    loss = _next_token_nll(logits[:, :-1], tokens[:, 1:])
    total = loss + 0.001 * aux
    if cfg.mtp:
        total = total + 0.3 * _mtp_loss(params, cfg, tokens, hidden)
    return total, {"lm": loss, "aux": aux}


def _mtp_loss(params, cfg: ModelConfig, tokens, hidden):
    """DeepSeek-V3 depth-1 multi-token prediction: predict t+2 from
    (h_t, emb(x_{t+1})) through one extra layer (the "mtp" subtree)."""
    mtp = params["mtp"]
    dtype = hidden.dtype
    B, T = tokens.shape
    h = apply_norm(mtp["norm_h"], hidden[:, : T - 1], cfg)
    e = apply_norm(mtp["norm_e"], quantize.embed_lookup(
        params["embed"], tokens[:, 1:], dtype), cfg)
    x = torch.cat([h, e], dim=-1) @ mtp["proj"].to(dtype)
    spec = LayerSpec(mixer="mla" if cfg.attention == "mla" else "attn",
                     cross=False, ffn="dense")
    pos = torch.arange(T - 1, dtype=torch.int32,
                       device=tokens.device).expand(B, T - 1)
    x, _ = _apply_layer(spec, mtp["layer"], None, x, pos, cfg,
                        seg_mask=None, write=False)
    x = apply_norm(params["final_norm"], x, cfg)
    return _next_token_nll(_logits(params, cfg, x)[:, : T - 2],
                           tokens[:, 2:])


# ====================================================== convenience wrappers

def prefill(params, cfg: ModelConfig, tokens, cache, frontend=None):
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device).expand(tokens.shape)
    return apply(params, cfg, tokens, positions, cache=cache,
                 frontend=frontend, write=True)


def decode_step(params, cfg: ModelConfig, tokens, cache, frontend=None):
    """tokens: (B, 1) next tokens at positions cache['lengths']."""
    positions = cache["lengths"][:, None]
    return apply(params, cfg, tokens, positions, cache=cache,
                 frontend=frontend, write=True)


def verify_chunk(params, cfg: ModelConfig, tokens, cache, positions=None,
                 seg_mask=None, write=False):
    """Score a draft segment (chain or tree) against the cache without
    committing. tokens: (B, G); positions default chain continuation."""
    B, G = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = cache["lengths"][:, None] + torch.arange(
            G, dtype=torch.int32, device=dev)
    if seg_mask is None:
        seg_mask = torch.tril(torch.ones((G, G), dtype=torch.bool,
                                         device=dev)).expand(B, G, G)
    return apply(params, cfg, tokens, positions, cache=cache,
                 seg_mask=seg_mask, write=write)


def extend(params, cfg: ModelConfig, tokens, cache, frontend=None):
    """Commit accepted tokens (chain) into the cache; returns logits too."""
    B, G = tokens.shape
    positions = cache["lengths"][:, None] + torch.arange(
        G, dtype=torch.int32, device=tokens.device)
    return apply(params, cfg, tokens, positions, cache=cache,
                 frontend=frontend, write=True)
