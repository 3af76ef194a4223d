"""MoE FFNs of the PyTorch port against `repro.models.moe`, the JAX model
and the JAX engine, and int8 drafters on SSM and hybrid models.

* `apply_moe` (sorted copies, per-expert products, un-permuted f32 sum)
  against the JAX `apply_moe` and `dense_moe_reference` at float32,
  rtol = atol = 1e-5, with the same load-balance `aux`; over expert
  counts, top-k, token counts, with and without the shared expert.
* Logits and `aux` of a reduced qwen2-moe-a2.7b and a reduced
  jamba-v0.1-52b (MoE FFN at its odd layers) against
  `repro.models.model.apply` at 1e-4, the weights bridged through
  `convert.params_from_numpy`; one group-size read per MoE layer.
* A `cosine` engine run with a MoE target commits the port's own greedy
  stream and the JAX engine's, with equal per-iteration commits.
* int8 drafters on SSM and hybrid models (the reference's
  `test_quantized_forward_runs_and_tracks_plain[ssm|hybrid]` and
  `test_mixed_pool_greedy_exact[ssm]`): quantized logits against JAX on
  the same quantized tree, the hybrid's MoE FFN left plain, and a mixed
  pool with an int8 SSM drafter greedy-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig, MoEConfig, SSMConfig
from repro.configs.drafters import int8_variant
from repro.configs.jamba_v0_1_52b import CONFIG as JAMBA
from repro.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import quantize as JQ
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import quantize as TQ
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


TOL = 1e-4
MAX_LEN = 64
NEW = 8


def _port(obj):
    """The port's copy of a reference config dataclass (nested ones
    too)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _port(v)
        kw[f.name] = v
    return getattr(tconfig, type(obj).__name__)(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _flat(t, prefix=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, t


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------- apply_moe

def _jit(fn):
    """The JAX function compiled once (cfg and moe static): one compile
    instead of one per eager primitive."""
    return jax.jit(fn, static_argnums=(2, 3))


def _moe_cfg(E, k, shared, d=16, f=12):
    moe = MoEConfig(n_routed=E, top_k=k, d_ff=f, n_shared=1 if shared else 0,
                    shared_d_ff=2 * f if shared else 0)
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=d,
                      n_heads=2, n_kv_heads=2, d_ff=f, vocab=16, moe=moe,
                      dtype="float32")
    return cfg, moe


# (E, k, token shape, shared expert)
MOE_CASES = [(4, 1, (1,), False), (4, 2, (7,), True), (8, 3, (13,), False),
             (6, 2, (3, 8), True), (60, 4, (40,), True)]


@pytest.mark.parametrize("E,k,shape,shared", MOE_CASES)
def test_apply_moe_matches_jax_and_dense_oracle(E, k, shape, shared):
    cfg, moe = _moe_cfg(E, k, shared)
    jp = JMOE.moe_params(jax.random.PRNGKey(E + k), cfg, moe)
    tp = _torch_tree(_np_tree(jp))
    tcfg, tmoe = _port(cfg), _port(moe)
    x = np.random.default_rng(E * k).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    out_j, aux_j = _jit(JMOE.apply_moe)(jp, jnp.asarray(x), cfg, moe)
    out_t, aux_t = TMOE.apply_moe(tp, torch.from_numpy(x), tcfg, tmoe)
    assert out_t.shape == out_j.shape and out_t.dtype == torch.float32
    _close(out_t, out_j, 1e-5)
    _close(out_t, _jit(JMOE.dense_moe_reference)(jp, jnp.asarray(x), cfg,
                                                 moe), 1e-5)
    _close(TMOE.dense_moe_reference(tp, torch.from_numpy(x), tcfg, tmoe),
           out_j, 1e-5)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * max(1.0, float(aux_j))
    # the routing itself: the same experts and weights
    logits = x.reshape(-1, cfg.d_model) @ np.asarray(jp["router"])
    wj, ij, pj = JMOE.route_topk(jnp.asarray(logits), k)
    wt, it, pt = TMOE.route_topk(torch.from_numpy(logits), k)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    _close(wt, wj, 1e-6)
    _close(pt, pj, 1e-6)


def test_apply_moe_bf16_dtypes_follow_the_reference():
    """bf16 activations: the routed sum comes back in bf16 and the shared
    expert's f32 product promotes the output to f32, as in JAX."""
    for shared in (False, True):
        cfg, moe = _moe_cfg(4, 2, shared)
        jp = JMOE.moe_params(jax.random.PRNGKey(1), cfg, moe)
        x = np.random.default_rng(0).standard_normal((5, 16)).astype(
            np.float32)
        out_j, _ = JMOE.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), cfg, moe)
        out_t, _ = TMOE.apply_moe(_torch_tree(_np_tree(jp)),
                                  torch.from_numpy(x).bfloat16(),
                                  _port(cfg), _port(moe))
        assert str(out_t.dtype).split(".")[-1] == str(out_j.dtype)
        np.testing.assert_allclose(out_t.float().numpy(),
                                   np.asarray(out_j, np.float32),
                                   rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------- models

def _reduced(name):
    if name == "qwen2-moe":
        return QWEN2_MOE.with_overrides(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128, vocab=96, dtype="float32",
            moe=MoEConfig(n_routed=8, top_k=4, d_ff=16, n_shared=4,
                          shared_d_ff=64))
    return JAMBA.with_overrides(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=96, dtype="float32", hybrid_attn_period=4,
        hybrid_attn_offset=2,
        moe=MoEConfig(n_routed=4, top_k=2, d_ff=32, layer_offset=1,
                      layer_period=2),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk_size=16))


@pytest.fixture(scope="module", params=["qwen2-moe", "jamba"])
def model_pair(request):
    cfg = _reduced(request.param)
    tree = _np_tree(JM.init_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    for stage in tree["stages"]:
        for sub in stage:
            for key in ("bq", "bk", "bv"):     # qwen's QKV biases matter
                if key in sub["mixer"]:
                    sub["mixer"][key] = rng.standard_normal(
                        sub["mixer"][key].shape).astype(np.float32) * 0.3
    tcfg = _port(cfg)
    return cfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu")


def test_model_logits_and_aux_match_jax(model_pair, monkeypatch):
    cfg, tcfg, tree, tp = model_pair
    specs = TM.layer_specs(tcfg)
    n_moe = sum(s.ffn == "moe" for s in specs)
    assert n_moe == 2
    assert all("router" in tp["layers"][i]["ffn"]
               for i, s in enumerate(specs) if s.ffn == "moe")
    reads = []
    orig = TMOE.group_sizes_host
    monkeypatch.setattr(TMOE, "group_sizes_host",
                        lambda *a: reads.append(1) or orig(*a))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 11))
    lj, _, aux_j = JM.apply(jax.tree.map(jnp.asarray, tree), cfg,
                            jnp.asarray(toks, jnp.int32))
    lt, _, aux_t = TM.apply(tp, tcfg, torch.tensor(toks))
    _close(lt, lj)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * max(1.0, float(aux_j))
    assert float(aux_t) > 0
    assert len(reads) == n_moe          # one group-size read a MoE layer


def test_moe_cached_prefill_and_decode_match_jax(model_pair):
    """Prefill into a cache, then two decode steps: logits at 1e-4."""
    cfg, tcfg, tree, tp = model_pair
    jp = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9))
    jc = JM.init_cache(cfg, 2, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 2, MAX_LEN, dtype=torch.float32, device="cpu")
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks, jnp.int32), jc)
    lt, tc, _ = TM.prefill(tp, tcfg, torch.tensor(toks), tc)
    _close(lt, lj)
    for step in ([[3], [7]], [[11], [2]]):
        lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(step, jnp.int32), jc)
        lt, tc, _ = TM.decode_step(tp, tcfg, torch.tensor(step), tc)
        _close(lt, lj)


# ------------------------------------------------------------- engine

def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    out = []
    for _ in range(n):
        out.append(int(torch.argmax(lg[0, -1, : cfg.vocab])))
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                      cache)
    return out


def _serve(engine_cls, target, drafters, cos, prompts, **kw):
    eng = engine_cls(target, drafters, cos, strategy="cosine",
                     max_len=MAX_LEN, seed=0, **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            [rec.committed for rec in stats.records], stats)


def test_moe_target_engine_is_greedy_exact_and_equals_jax():
    """A reduced qwen2-moe target with a random dense drafter and a
    perfect one (the target's weights): the committed streams equal the
    port's greedy decode and the JAX engine's, iteration by iteration."""
    cfg = _reduced("qwen2-moe")
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=cfg.vocab, tie_embeddings=True,
                       dtype="float32")
    tp = _np_tree(JM.init_params(jax.random.PRNGKey(0), cfg))
    dp = _np_tree(JM.init_params(jax.random.PRNGKey(1), dcfg))
    tcfg, tdcfg = _port(cfg), _port(dcfg)
    ttp = params_from_numpy(tp, tcfg, "cpu")
    tdp = params_from_numpy(dp, tdcfg, "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (6, 7)]
    cos = CoSineConfig(n_drafters=2, draft_len=3, drafters_per_request=2,
                       tree_width=2)
    t_streams, t_iters, t_stats = _serve(
        SpeculativeEngine, (tcfg, ttp), [(tdcfg, tdp, "d0"),
                                         (tcfg, ttp, "d1")],
        _port(cos), prompts, device="cpu")
    for stream, p in zip(t_streams, prompts):
        assert stream == _greedy(tcfg, ttp, p, NEW)
    assert t_stats.mean_acceptance > 1.0
    j_streams, j_iters, _ = _serve(JaxEngine, (cfg, tp),
                                   [(dcfg, dp, "d0"), (cfg, tp, "d1")], cos,
                                   prompts)
    assert t_streams == j_streams
    assert t_iters == j_iters


# ------------------------------------------- int8 drafters: SSM, hybrid

def _quant_family(kind):
    cfg = tiny_model_cfg(kind)
    if kind == "hybrid":      # the hybrid drafter carries routed experts
        cfg = cfg.with_overrides(moe=MoEConfig(
            n_routed=4, top_k=2, d_ff=32, n_shared=1, shared_d_ff=32,
            layer_offset=1, layer_period=2))
    return cfg


@pytest.mark.parametrize("kind", ["ssm", "hybrid"])
def test_quantized_ssm_and_hybrid_forward_tracks_plain_and_jax(kind):
    """Quantize in JAX then convert == convert then quantize in the port,
    bitwise; the whole MoE FFN stays plain; quantized prefill and decode
    logits match JAX on the same quantized tree (1e-4) and the argmax
    tracks the unquantized model."""
    cfg = _quant_family(kind)
    tcfg = _port(cfg)
    tree = _np_tree(JM.init_params(jax.random.PRNGKey(0), cfg))
    qtree = JQ.quantize_params(tree, cfg)
    tq = params_from_numpy(_np_tree(qtree), tcfg, "cpu")
    via_port = TQ.quantize_params(params_from_numpy(tree, tcfg, "cpu"))
    a, b = dict(_flat(tq)), dict(_flat(via_port))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key],
                                                            b[key]), key
    specs = TM.layer_specs(tcfg)
    for spec, layer in zip(specs, tq["layers"]):
        assert TQ.is_quantized(layer["mixer"]["in_proj" if spec.mixer
                                              == "ssm" else "wq"])
        if spec.ffn == "moe":
            ffn = layer["ffn"]
            assert not any(TQ.is_quantized(v) for v in ffn.values())
            assert not any(TQ.is_quantized(v)
                           for v in ffn["shared"].values())
    assert any(s.ffn == "moe" for s in specs) == (kind == "hybrid")
    toks = np.asarray([[1, 5, 9, 2, 7, 3]], np.int32)
    jq = jax.tree.map(jnp.asarray, qtree)
    jc = JM.init_cache(cfg, 1, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lj, jc, _ = JM.prefill(jq, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = TM.prefill(tq, tcfg, torch.tensor(toks), tc)
    _close(lt, lj)
    lj2, _, _ = JM.decode_step(jq, cfg, jnp.asarray([[4]]), jc)
    lt2, _, _ = TM.decode_step(tq, tcfg, torch.tensor([[4]]), tc)
    _close(lt2, lj2)
    plain = params_from_numpy(tree, tcfg, "cpu")
    lp, _, _ = TM.apply(plain, tcfg, torch.tensor(toks))
    lq, _, _ = TM.apply(tq, tcfg, torch.tensor(toks))
    agree = (lp[..., : cfg.vocab].argmax(-1)
             == lq[..., : cfg.vocab].argmax(-1)).float().mean()
    assert float(agree) >= 0.5


def test_mixed_pool_with_int8_ssm_drafter_is_greedy_exact():
    """An SSM target served with an int8 copy of itself beside a
    full-precision SSM drafter: every committed stream equals the
    target's greedy decode, and the int8 node's in_proj and out_proj
    went through the int8 GEMV's wrapper."""
    from repro_torch.kernels.int8_gemv import ops as ig
    cfg = tiny_model_cfg("ssm")
    tcfg = _port(cfg)
    tp = params_from_numpy(_np_tree(JM.init_params(jax.random.PRNGKey(0),
                                                   cfg)), tcfg, "cpu")
    dp = params_from_numpy(_np_tree(JM.init_params(jax.random.PRNGKey(1),
                                                   cfg)), tcfg, "cpu")
    drafters = [(_port(int8_variant(cfg)), tp, "d0"), (tcfg, dp, "d1")]
    cos = tconfig.CoSineConfig(n_drafters=2, draft_len=4,
                               drafters_per_request=2, tree_width=2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, 8).tolist() for _ in range(3)]
    calls = []
    orig = ig.int8_gemv

    def counted(x, *a, **kw):
        calls.append(x.shape[-1])
        return orig(x, *a, **kw)

    ig.int8_gemv = counted
    try:
        streams, _, stats = _serve(SpeculativeEngine, (tcfg, tp), drafters,
                                   cos, prompts, device="cpu")
    finally:
        ig.int8_gemv = orig
    assert stats.mean_acceptance > 1.0
    assert cfg.d_model in calls            # in_proj reads d_model columns
    for stream, p in zip(streams, prompts):
        assert stream == _greedy(tcfg, tp, p, NEW)
