"""Weight-only int8 drafters of the PyTorch port against `repro.models
.quantize` and the JAX engine.

* `quantize_weight` / `quantize_params` give bitwise the reference's
  `w8` and `scale` for the same numpy weights (round half to even on both
  sides), whether the tree is quantized in JAX and converted or
  converted and quantized in the port.
* The int8 GEMV's plain version (what its wrapper runs on CPU tensors)
  matches the reference oracle and the Pallas kernel in interpret mode at
  rtol = atol = 1e-5, on aligned and unaligned shapes, for both weight
  layouts. Not bitwise: f32 sums in another order.
* Quantized `qdot` / `tied_logits` / `embed_lookup` and a quantized
  model's logits match the reference at float32 (1e-5 / 1e-4).
* A mixed pool (an int8 drafter beside a full-precision one) serves
  greedy-exact streams equal to the JAX engine's, with equal
  per-iteration commit counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig
from repro.configs.drafters import int8_variant
from repro.kernels.int8_gemv.ops import int8_gemv as pallas_int8_gemv
from repro.kernels.int8_gemv.ref import int8_gemv_ref
from repro.models import model as JM
from repro.models import quantize as JQ
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.int8_gemv import ops as ig
from repro_torch.models import model as TM
from repro_torch.models import quantize as TQ
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine
from repro_torch.serving.runner import ModelRunner


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 64
NEW = 8


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(t, ref):
    """Port tree (tensors) equals a reference tree of numpy leaves, bit
    for bit, with the same leaf structure."""
    if isinstance(ref, dict):
        assert isinstance(t, dict) and set(t) == set(ref)
        for k in ref:
            _assert_tree_equal(t[k], ref[k])
    else:
        a = t.detach().cpu().numpy()
        assert a.dtype == ref.dtype and a.shape == ref.shape
        np.testing.assert_array_equal(a, ref)


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("axis,shape", [(-2, (37, 23)), (-1, (50, 16)),
                                        (-2, (3, 8, 12))])
def test_quantize_weight_bitwise(axis, shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    # a zero output channel (scale 1, all-zero w8) and exact .5 ties
    if axis == -2:
        w[..., :, 3] = 0.0
    else:
        w[4, :] = 0.0
    w.flat[7] = 127.0
    w.flat[8] = 63.5
    ref = _np_tree(JQ.quantize_weight(jnp.asarray(w), axis=axis))
    got = TQ.quantize_weight(torch.from_numpy(w), axis=axis)
    _assert_tree_equal(got, ref)
    back = TQ.dequantize_weight(got).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(JQ.dequantize_weight(JQ.quantize_weight(
            jnp.asarray(w), axis=axis))))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_model_cfg("attn")
    tree = _np_tree(JM.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, _tcfg(cfg), tree


def test_quantize_params_two_routes_bitwise(tiny):
    """Quantize in JAX then convert == convert then quantize in the port,
    bit for bit, leaf for leaf; idempotent, norms untouched."""
    cfg, tcfg, tree = tiny
    via_jax = params_from_numpy(_np_tree(JQ.quantize_params(tree, cfg)),
                                tcfg, "cpu")
    via_port = TQ.quantize_params(params_from_numpy(tree, tcfg, "cpu"), tcfg)
    assert TQ.is_quantized(via_port["embed"])
    assert via_port["embed"]["scale"].shape == (cfg.padded_vocab, 1)
    lay = via_port["layers"][0]
    assert lay["mixer"]["wq"]["w8"].dtype == torch.int8
    assert lay["mixer"]["wq"]["scale"].shape == (1, lay["mixer"]["wq"]
                                                 ["w8"].shape[1])
    assert not TQ.is_quantized(lay["ln1"]["scale"])

    def flat(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, t

    a, b = dict(flat(via_jax)), dict(flat(via_port))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    again = TQ.quantize_params(via_port)
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(flat(again), flat(via_port)))


def test_quantize_params_rejects_mla_and_keeps_moe():
    layer = {"ln1": {"scale": torch.ones(4)},
             "mixer": {"wdq": torch.zeros(4, 4)}}
    with pytest.raises(ValueError, match="MLA"):
        TQ.quantize_params({"embed": torch.ones(8, 4), "layers": [layer]})
    moe = {"router": torch.ones(4, 2), "wg": torch.ones(2, 4, 8)}
    out = TQ.quantize_params({"embed": torch.ones(8, 4),
                              "layers": [{"ffn": moe}]})
    assert out["layers"][0]["ffn"] is moe


def test_resolve_drafter_quant_per_node(tiny):
    _, tcfg, tree = tiny
    p = params_from_numpy(tree, tcfg, "cpu")
    specs = [(tcfg.with_overrides(quant="int8"), p, "a"),
             (tcfg.with_overrides(quant="none"), p, "b"),
             (tcfg, p, "c")]
    out = TQ.resolve_drafter_quant(specs, pool_default="int8")
    assert [c.quant for c, _, _ in out] == ["int8", "none", "int8"]
    assert [TQ.is_quantized(q["embed"]) for _, q, _ in out] == \
        [True, False, True]
    # the pool default "none" leaves unmarked nodes at full precision
    out = TQ.resolve_drafter_quant(specs, pool_default="none")
    assert [TQ.is_quantized(q["embed"]) for _, q, _ in out] == \
        [True, False, False]


# ------------------------------------------------------------ int8 GEMV

@pytest.mark.parametrize("B,K,N", [(8, 64, 256), (1, 32, 128), (3, 50, 70),
                                   (5, 7, 13)])
def test_int8_gemv_plain_matches_reference_and_pallas(B, K, N):
    rng = np.random.default_rng(B * 1000 + K)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = (rng.random((1, N)) * 0.02 + 1e-3).astype(np.float32)
    ref = np.asarray(int8_gemv_ref(jnp.asarray(x), jnp.asarray(w8),
                                   jnp.asarray(scale)))
    pal = np.asarray(pallas_int8_gemv(jnp.asarray(x), jnp.asarray(w8),
                                      jnp.asarray(scale), interpret=True))
    tx, tw, ts = map(torch.from_numpy, (x, w8, scale))
    plain = ig.int8_gemv_plain(tx, tw, ts).numpy()
    # the wrapper on CPU tensors, dense and transposed-table layouts
    dense = ig.int8_gemv(tx, tw, ts).numpy()
    table = tw.t().contiguous()                     # (N, K) like (V, D)
    trans = ig.int8_gemv(tx, table.t(), ts.reshape(N, 1)).numpy()
    for got in (plain, dense, trans):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    assert ig.LAUNCHES == 0            # CPU tensors never launch


def test_quantized_ops_match_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    emb = (0.02 * rng.standard_normal((30, 24))).astype(np.float32)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    toks = rng.integers(0, 30, (2, 5)).astype(np.int32)
    jw, je = JQ.quantize_weight(jnp.asarray(w)), \
        JQ.quantize_weight(jnp.asarray(emb), axis=-1)
    tw = TQ.quantize_weight(torch.from_numpy(w))
    te = TQ.quantize_weight(torch.from_numpy(emb), axis=-1)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(TQ.qdot(tx, tw).numpy(),
                               np.asarray(JQ.qdot(jnp.asarray(x), jw)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TQ.tied_logits(te, tx).numpy(),
                               np.asarray(JQ.tied_logits(je, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        TQ.embed_lookup(te, torch.from_numpy(toks), torch.float32).numpy(),
        np.asarray(JQ.embed_lookup(je, jnp.asarray(toks), jnp.float32)))


def test_quantized_model_logits_match_jax(tiny):
    """A quantized model's forward (prefill logits, then a cached decode
    step) against JAX `apply` on the same quantized tree, at 1e-4."""
    cfg, tcfg, tree = tiny
    qtree = JQ.quantize_params(tree, cfg)
    tp = params_from_numpy(_np_tree(qtree), tcfg, "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9))
    lj, _, _ = JM.apply(qtree, cfg, jnp.asarray(toks, jnp.int32))
    lt, _, _ = TM.apply(tp, tcfg, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    # and the runner's routing table is the dequantized embedding
    runner = ModelRunner(tcfg, tp, MAX_LEN, device="cpu")
    np.testing.assert_array_equal(
        runner.embed_np,
        np.asarray(JQ.dequantize_weight(qtree["embed"]))[: cfg.vocab])


# ------------------------------------------------------------ mixed pools

@pytest.fixture(scope="module")
def mixed():
    tcfg = tiny_model_cfg("attn")
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=50, tie_embeddings=True,
                       dtype="float32")
    tp = _np_tree(JM.init_params(jax.random.PRNGKey(0), tcfg))
    dp = _np_tree(JM.init_params(jax.random.PRNGKey(1), dcfg))
    # node 0: an int8 copy of the target (proposals change, acceptance
    # stays high); node 1: a random full-precision drafter
    jax_side = ((tcfg, tp), [(int8_variant(tcfg), tp, "d0"),
                             (dcfg, dp, "d1")])
    ttp = params_from_numpy(tp, _tcfg(tcfg), "cpu")
    tdp = params_from_numpy(dp, _tcfg(dcfg), "cpu")
    torch_side = ((_tcfg(tcfg), ttp),
                  [(_tcfg(int8_variant(tcfg)), ttp, "d0"),
                   (_tcfg(dcfg), tdp, "d1")])
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 50, n).tolist() for n in (7, 12)]
    return jax_side, torch_side, prompts


def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    out = []
    for _ in range(n):
        out.append(int(torch.argmax(lg[0, -1, : cfg.vocab])))
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                      cache)
    return out


def _serve(engine_cls, target, drafters, cos, strategy, prompts, **kw):
    eng = engine_cls(target, drafters, cos, strategy=strategy,
                     max_len=MAX_LEN, seed=0, **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            [rec.committed for rec in stats.records], stats, eng)


@pytest.mark.parametrize("strategy", ["cosine", "specinfer"])
def test_mixed_pool_greedy_exact_and_equal_to_jax(mixed, strategy):
    (jt, jd), (tt, td), prompts = mixed
    cos = CoSineConfig(n_drafters=2, draft_len=3, drafters_per_request=2,
                       tree_width=2)
    t_streams, t_iters, t_stats, eng = _serve(
        SpeculativeEngine, tt, td, _tcfg(cos), strategy, prompts,
        device="cpu")
    assert TQ.is_quantized(eng.drafters[0].params["embed"])
    assert not TQ.is_quantized(eng.drafters[1].params["embed"])
    # the latency model prices the int8 node at its own pace
    assert [p.speed for p in eng.drafter_profiles] == [0.6, 1.0]
    for stream, p in zip(t_streams, prompts):
        assert stream == _greedy(tt[0], tt[1], p, NEW)
    j_streams, j_iters, j_stats, _ = _serve(JaxEngine, jt, jd, cos,
                                            strategy, prompts)
    assert t_streams == j_streams
    assert t_iters == j_iters
    assert t_stats.total_committed == j_stats.total_committed
    assert t_stats.mean_acceptance > 1.0


# ------------------------------------------------- the kernel's path plan

INT8_PLAN_SHAPES = [(4, 896, 128), (4, 896, 896), (4, 896, 4864),
                    (4, 4864, 896), (1, 37, 13), (8, 100, 4864),
                    (24, 896, 896), (512, 896, 4864), (4, 896, 151936),
                    (512, 896, 151936), (64, 37, 13), (77, 144, 208),
                    (3, 5000, 7), (9, 64, 64)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rows_layout", [False, True])
@pytest.mark.parametrize("M,K,N", INT8_PLAN_SHAPES)
def test_int8_plan_covers_every_row_and_column_once(M, K, N, rows_layout,
                                                    bf16):
    """The path comes from the shapes alone: wgmma for bf16 x from
    TC_MIN_ROWS rows, else the rows kernel for the transposed table and
    split-K for the dense layout. The
    cluster ranks of split-K (rows of K) and of wgmma (k-tiles) cut K
    into contiguous ranges read once each, each long enough but the last,
    and the dynamic shared memory every path asks for fits a block (a
    `gpu` test holds it, with the static part, against the compiled
    kernels)."""
    p = ig.plan(M, K, N, rows_layout, bf16)
    assert ig.plan_smem(p, K) <= SMEM_LIMIT
    if bf16 and M >= ig.TC_MIN_ROWS:
        assert p.path == "tc" and p.bn in (64, 128)
        assert p.cs in ig.CLUSTER_SIZES
        ranges = ig.tc_ranges(K, p.cs)
        assert ranges[0][0] == 0 and ranges[-1][1] == -(-K // ig.TC_BK)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if p.cs > 1:       # all but the last non-empty rank
            full = [hi - lo for lo, hi in ranges if hi > lo][:-1]
            assert all(n >= ig.TC_MIN_KTILES for n in full)
        return
    assert p.mb in (1, 2, 4, 8) and p.mb <= max(1, 2 * min(M, 8) - 1)
    if rows_layout:
        assert p.path == "rows" and p.sms > 0
        assert ig.rows_smem(p.mb, K) <= ig.ROWS_SMEM_MAX
        return
    assert p.path == "splitk"
    assert p.cs in ig.CLUSTER_SIZES
    ranges = ig.splitk_ranges(K, p.cs)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if p.cs > 1:           # all but the last non-empty rank
        full = [hi - lo for lo, hi in ranges if hi > lo][:-1]
        assert all(n >= ig.SPLITK_MIN_ROWS for n in full)


@pytest.mark.parametrize("K,N", [(896, 128), (896, 896), (896, 4864),
                                 (4864, 896)])
def test_int8_decode_products_fill_the_card(K, N):
    """Every decode product of qwen2-0.5b (4 rows) launches at least
    SPLITK_TARGET_BLOCKS blocks of the split-K path, no rank reading
    more than SPLITK_MAX_ROWS rows."""
    p = ig.plan(4, K, N, False, True)
    assert p.path == "splitk"
    assert -(-N // ig.SPLITK_TN) * p.cs >= ig.SPLITK_TARGET_BLOCKS
    assert -(-K // p.cs) <= ig.SPLITK_MAX_ROWS
