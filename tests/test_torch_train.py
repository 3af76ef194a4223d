"""Training on the PyTorch port against the JAX package (CPU, float32).

* `fa.attention`'s backward (the tensor-op gradient that runs after the
  kernel's forward on the card, and after the plain forward here)
  against autograd through `attend_partial_plain`, in each masking case;
  within 1e-5 of each gradient's largest value (the two sum the same f32
  products in another order: ~1e-7).
* `lm_loss` and every gradient leaf against
  `jax.value_and_grad(repro.models.model.lm_loss)` on reduced configs of
  eight architectures (one tree in the reference's layout through the
  weight bridge, norm scales and biases perturbed so they matter; the
  same inputs, a frontend for the VLM and Whisper), `remat` off
  and, for qwen2-0.5b and deepseek-v3-671b, on: each leaf within 1e-4 of
  its largest value (2e-4 for SSM and hybrid, the SSD tests' tolerance),
  the loss within 1e-5. Two frameworks' f32 products in different
  orders; the loss is O(10).
* The three optimizers against the reference's, three steps on the same
  gradients: within 1e-6 (f32 arithmetic in the same order).
* `train_model`'s five losses from converted JAX parameters against the
  JAX `train_model`'s, within 1e-4, and the first step's gradients.
  Parameters after AdamW are not compared: where a gradient is near zero
  the first update is +-lr with the sign of float noise.

TF32 plays no part on the CPU; float32 products stay float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import OPTIONS as _FAST_COMPILE
from repro.configs import ARCHS
from repro.configs.drafters import tiny_drafter
from repro.data.synthetic import SyntheticCorpus as JCorpus
from repro.data.synthetic import token_batches
from repro.launch import train as JT
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro_torch import config as tconfig
from repro_torch.data.synthetic import SyntheticCorpus as TCorpus
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import optimizers as TO

PERTURBED = ("scale", "bias", "bi", "bo", "bq", "bk", "bv")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the whole suite runs in several
    pytest-xdist workers at once, and under that load torch's OpenMP pool
    on every core made the small operations here up to ~100x slower (the
    serve test took 115 s on a loaded host at the default thread count,
    15 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (v + rng.normal(0, 0.1, v.shape).astype(v.dtype)
                    if k in PERTURBED and not isinstance(v, dict)
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _models(cfg, seed=0):
    """(JAX params, port params) from one perturbed tree in the
    reference's layout: the port's `init_params` restacked by
    `params_to_numpy` (the JAX `init_params` compiles for seconds a
    config on the CPU; `test_torch_checkpoint.py` holds the restacking to
    the reference's trees)."""
    tcfg = _tcfg(cfg)
    tree = params_to_numpy(TM.init_params(tcfg, seed, device="cpu"), tcfg)
    tree = _perturb(tree, np.random.default_rng(seed + 100))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, "cpu"))


def _grads_close(tgrads, jgrads, cfg, tol):
    """Every port gradient leaf against the reference's (its stacked
    tree split per layer by the weight bridge)."""
    ref = params_from_numpy(jax.tree.map(np.asarray, jgrads), _tcfg(cfg),
                            "cpu")
    assert len(TO.tree_leaves(tgrads)) == len(TO.tree_leaves(ref))

    def close(t, r):
        assert t.shape == r.shape
        scale = max(float(r.abs().max()), 1e-12)
        assert float((t - r).abs().max()) <= tol * scale

    # (keyed: the reference's dicts come back with sorted keys)
    TO.tree_map(close, tgrads, ref)


# ---------------------------------------------------------------------
# the attention gradient


def _tree_mask(B, T, S, seed):
    """Ancestor masks of random trees over the last T keys (the earlier
    S - T are history every node sees)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T, S), bool)
    mask[:, :, : S - T] = True
    for b in range(B):
        for i in range(T):
            mask[b, i, S - T + i] = True
            if i:
                p = rng.integers(0, i)
                mask[b, i, S - T:] |= mask[b, p, S - T:]
    return torch.tensor(mask)


ATTENTION_CASES = {
    # name: (T, S, Hkv, G, Dk, Dv, keyword arguments)
    "causal": (7, 7, 2, 1, 16, 16, {}),
    "window": (9, 300, 2, 1, 16, 16, dict(window=5)),
    "tree": (6, 20, 1, 2, 32, 32, dict(mask=_tree_mask(2, 6, 20, 0))),
    "gqa": (5, 40, 2, 4, 16, 16, {}),
    "noncausal": (5, 11, 2, 2, 16, 16, dict(causal=False)),
    "latent": (4, 9, 1, 4, 40, 32, {}),
    "masked_row": (5, 9, 2, 2, 16, 16, dict(
        mask=torch.ones(2, 5, 9, dtype=torch.bool).index_fill_(
            1, torch.tensor([1]), False))),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_grad_matches_autograd_through_plain(case):
    T, S, Hkv, G, Dk, Dv, kw = ATTENTION_CASES[case]
    B = 2
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((B, T, Hkv, G, Dk)),
                     dtype=torch.float32, requires_grad=True)
    k = torch.tensor(rng.standard_normal((B, S, Hkv, Dk)),
                     dtype=torch.float32, requires_grad=True)
    # the latent case reads V as K's first Dv columns (MLA's view)
    v = (k[..., :Dv] if case == "latent" else
         torch.tensor(rng.standard_normal((B, S, Hkv, Dv)),
                      dtype=torch.float32, requires_grad=True))
    q_pos = torch.arange(S - T, S, dtype=torch.int32).expand(B, T)
    k_pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    d_out = torch.tensor(rng.standard_normal((B, T, Hkv, G, Dv)),
                         dtype=torch.float32)
    inputs = [q, k] if case == "latent" else [q, k, v]
    args = (q, k, v, q_pos, k_pos)
    kw = dict(scale=Dk ** -0.5, **kw)

    out = fa.attention(*args, **kw)
    got = torch.autograd.grad((out * d_out).sum(), inputs)
    want_out = fa.finalize(fa.attend_partial_plain(*args, **kw))
    want = torch.autograd.grad((want_out * d_out).sum(), inputs)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    if case == "masked_row":
        # the fully masked row gives 0 and no gradient to its query
        assert float(out.detach()[:, 1].abs().max()) == 0.0
        assert float(got[0][:, 1].abs().max()) == 0.0


# ---------------------------------------------------------------------
# lm_loss against the reference


def _arch(name, **cut):
    return ARCHS[name].reduced().with_overrides(dtype="float32", **cut)


def _deepseek():
    """One MLA layer with the MoE FFN and the MTP module, an MLA layer
    with the dense FFN (the reference's 3 dense layers and 58 MoE ones
    cut to the MoE one: the MTP layer is the dense one)."""
    cfg = _arch("deepseek-v3-671b", n_layers=1)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                      layer_offset=0))


def _jamba():
    """An SSM layer with the MoE FFN, then an attention layer with the
    dense FFN."""
    cfg = _arch("jamba-v0.1-52b", n_layers=2, hybrid_attn_offset=1)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                      layer_offset=0))


LOSS_CASES = {
    # depth cut where the plan keeps its structure: one layer where every
    # layer is alike; jamba to an SSM layer with the MoE FFN and then an
    # attention layer with the dense one (the full model's pairing: its
    # attention layers sit at even indices, its MoE at odd), the VLM to a
    # self-attention layer and then a cross-attention one, whisper to one
    # decoder and one encoder layer; qwen2-0.5b keeps two layers, so a
    # restacked stage of more than one layer is checked; danube's window
    # cut to 8 so a 16-token sequence crosses it
    "qwen2-0.5b": (_arch("qwen2-0.5b"), 1e-4),
    "qwen2-moe-a2.7b": (_arch("qwen2-moe-a2.7b", n_layers=1), 1e-4),
    "deepseek-v3-671b": (_deepseek(), 1e-4),
    "h2o-danube3-4b": (_arch("h2o-danube3-4b", n_layers=1,
                             sliding_window=8), 1e-4),
    "mamba2-130m": (_arch("mamba2-130m", n_layers=1), 2e-4),
    "jamba-v0.1-52b": (_jamba(), 2e-4),
    "llama-3.2-vision-11b": (_arch("llama-3.2-vision-11b", n_layers=2,
                                   cross_attn_offset=1), 1e-4),
    "whisper-small": (_arch("whisper-small", n_layers=1, encoder_layers=1),
                      1e-4),
}


def _frontend(cfg, batch):
    n = cfg.encoder_seq if cfg.is_encdec else cfg.n_frontend_tokens
    if not n:
        return None
    return (np.random.default_rng(3).standard_normal(
        (batch, n, cfg.d_model)) * 0.1).astype(np.float32)


_REFERENCE = {}


_JIT = jax.jit


def _fast_jit(fn, **kw):
    """`jax.jit(fn)` compiled with `_FAST_COMPILE`, once for each
    structure and shapes of its (positional) arguments."""
    jitted = _JIT(fn, **kw)
    compiled = {}

    def call(*args):
        key = (jax.tree.structure(args),
               tuple(np.shape(a) for a in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=_FAST_COMPILE)
        return compiled[key](*args)

    return call


def _reference(name):
    """The JAX loss and gradients of a case (its models and inputs too),
    computed once: `remat` changes what is kept, not the values, so the
    port's remat run is held to the same reference."""
    if name not in _REFERENCE:
        cfg, _ = LOSS_CASES[name]
        jp, tp = _models(cfg)
        toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
        toks = jnp.asarray(toks.astype(np.int32))
        fe = _frontend(cfg, 2)
        fe = None if fe is None else jnp.asarray(fe)
        ref = _fast_jit(lambda p, t, f: jax.value_and_grad(
            JM.lm_loss, has_aux=True)(p, cfg, t, frontend=f, remat=False))(
                jp, toks, fe)
        _REFERENCE[name] = (tp, np.asarray(toks),
                            None if fe is None else np.asarray(fe), ref)
    return _REFERENCE[name]


@pytest.mark.parametrize("name,remat", [
    (n, False) for n in LOSS_CASES] + [("qwen2-0.5b", True),
                                        ("deepseek-v3-671b", True)])
def test_lm_loss_and_grads_match_reference(name, remat):
    cfg, tol = LOSS_CASES[name]
    tcfg = _tcfg(cfg)
    tp, toks, fe, ((jloss, jparts), jgrads) = _reference(name)
    loss, parts, grads = TT.value_and_grad(
        tp, tcfg, torch.tensor(toks),
        frontend=None if fe is None else torch.tensor(fe), remat=remat)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(parts["lm"]) - float(jparts["lm"])) <= 1e-5 * abs(
        float(jparts["lm"]))
    assert abs(float(parts["aux"]) - float(jparts["aux"])) <= 1e-5 * max(
        1.0, abs(float(jparts["aux"])))
    _grads_close(grads, jgrads, cfg, tol)


# ---------------------------------------------------------------------
# optimizers and the training loop


def _opt_tree(rng):
    """A tree with the port's containers (a dict of matrices, vectors and
    a list of layer dicts), factored and unfactored for Adafactor."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": a(12, 16), "layers": [{"w": a(16, 8), "b": a(8)},
                                           {"w": a(2, 9, 10), "s": a(5)}]}


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(4)
    tree = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jopt, topt = JO.get_optimizer(name, 1e-2), TO.get_optimizer(name, 1e-2)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = TO.tree_map(torch.tensor, tree)
    js, ts = jopt.init(jp), topt.init(tp)

    def jstep(g, s, p):
        u, s = jopt.update(g, s, p)
        return JO.apply_updates(p, u), s

    jstep = _fast_jit(jstep)
    for g in grads:
        jp, js = jstep(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(TO.tree_map(torch.tensor, g), ts, tp)
        TO.apply_updates(tp, tu)
    got = jax.tree.leaves(TO.tree_map(lambda t: t.numpy(), tp))
    for t, j in zip(got, jax.tree.leaves(jp)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=1e-6)


def test_train_model_matches_reference(monkeypatch):
    """Five AdamW steps on one domain from the same converted parameters:
    the same batches (the corpus is a copy seeded alike), the same
    losses; the first step's gradients leaf by leaf. (The reference's
    `train_model` runs as it is, its step compiled by `_fast_jit`.)"""
    cfg = tiny_drafter(64).with_overrides(dtype="float32", n_layers=1)
    tcfg = _tcfg(cfg)
    jp, tp = _models(cfg, seed=5)
    monkeypatch.setattr(JT.jax, "jit", _fast_jit)
    _, jlosses = JT.train_model(cfg, JCorpus(64, seed=0), "piqa", 5,
                                batch=4, seq=16, params=jp, verbose=False)
    monkeypatch.undo()
    params, losses = TT.train_model(tcfg, TCorpus(64, seed=0), "piqa", 5,
                                    batch=4, seq=16, params=tp,
                                    verbose=False, device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    # a copy was trained, returned without gradients; `tp` is untouched
    assert not any(t.requires_grad for t in TO.tree_leaves(params))
    assert torch.equal(tp["embed"], params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")["embed"])
    first = next(token_batches(JCorpus(64, seed=0), "piqa", 4, 16, 1))
    _, jgrads = _fast_jit(lambda p, t: jax.value_and_grad(
        JM.lm_loss, has_aux=True)(p, cfg, t, remat=False))(
            jp, jnp.asarray(first))
    _, _, grads = TT.value_and_grad(tp, tcfg, torch.tensor(first),
                                    remat=False)
    _grads_close(grads, jgrads, cfg, 1e-4)
