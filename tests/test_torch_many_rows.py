"""Kernels 1 and 2's many-row form and int8 K/V at head width 120, on the
CPU: what the wrappers choose and check, and the reduced h2o-danube3-4b
with int8 KV caches against `repro`.

* `tiling` sends f32 / bf16 K/V of head width 64, 120 or 128 to the
  many-row form (64 query rows a block) from `R_MMA` rows and everything
  else where it went; `plan_splits` covers the keys with the GQA form's
  32-key tiles and a span from the grid alone; `kernel_smem` counts the
  many-row form's and the D 120 int8 form's shared memory.
* The resident and the paged wrapper launch the same form, split and
  row tile for the same (B, Hkv, R, S, D, dtype), read off the launch
  arguments (the kernels' C entry points replaced by recorders).
* `check_pair` takes int8 K/V at D 120, whose rows need 8-byte
  alignment only (`kv_align`).
* The reduced h2o-danube3-4b (head width 120) with `kv_dtype="int8"`:
  prefill, decode and a tree verification against the JAX package's int8
  path (logits 1e-4, scales 1e-5, as `test_torch_int8kv.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _jax_fast_compile import fast_compile
from repro.configs import ARCHS
from repro.models import model as JM
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from test_torch_int8kv import _eq, _tcfg


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield



@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("D", fa.MMA_HEADS)
def test_tiling_takes_the_many_row_form_from_r_mma(size, D):
    """At R_MMA rows and above, f32 (4 bytes) or bf16 (2) K/V of width D
    take 64-row blocks; below it, and for D 16 and 32, int8 K/V or the
    latent form, the forms keep their row tiles; the key tile is always
    the GQA form's 32 (so the plain version's tile stays KEY_TILE)."""
    r = fa.R_MMA
    assert fa.MMA_HEADS == (64, 120, 128) and r == 17
    gqa = (fa.KEY_TILE, fa.MAX_SPLIT, fa.ROW_TILE)
    many = (fa.KEY_TILE, fa.MAX_SPLIT, fa.MMA_ROW_TILE)
    assert fa.tiling(False, False, r - 1, D, size) == gqa
    assert fa.tiling(False, False, r, D, size) == many
    assert fa.tiling(False, False, 4 * r + 3, D, size) == many
    assert fa.tiling(False, False, 4 * r) == gqa          # no D, dtype
    assert fa.tiling(False, True, 4 * r, D, 1)[2] == 64   # int8 form
    assert fa.tiling(False, True, 16, D, 1)[2] == 16
    assert fa.tiling(True, False, 4 * r, D, size) == (
        fa.LATENT_KEY_TILE, fa.LATENT_MAX_SPLIT, fa.LATENT_ROW_TILE)
    for d in (16, 32):
        assert fa.tiling(False, False, 4096, d, size) == gqa
    assert fa.key_tile(D, D) == fa.KEY_TILE


# (B, Hkv, R, S): a prefill chunk, the encoder, commits and cache passes
MANY_SHAPES = [(1, 8, 2048, 1024), (1, 12, 1500, 1500), (4, 8, 40, 1024),
               (4, 8, 24, 700), (3, 2, 512, 300), (1, 1, 64, 33)]


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("B,H,R,S", MANY_SHAPES)
def test_many_row_plan_covers_every_key_tile_once(B, H, R, S, size):
    """The many-row form's split: power-of-two clusters of at most
    MAX_SPLIT blocks whose spans of whole 32-key tiles cover the keys
    once in rank order; the span depends on the grid (64-row tiles)
    alone, never on S, and meets the block target at the reference
    capacity unless the cluster limit stops it."""
    D = 120
    R = max(R, fa.R_MMA)
    n, span = fa.plan_splits(B, H, R, S, False, False, D, size)
    assert 1 <= n <= fa.MAX_SPLIT and n & (n - 1) == 0 and span >= 1
    assert span == fa.plan_splits(B, H, R, 3 * S + 5, False, False, D,
                                  size)[1]
    tiles = sorted(t for keys in fa.split_ranges(S, n, span)
                   for lo, hi in keys
                   for t in range(lo // fa.KEY_TILE, -(-hi // fa.KEY_TILE)))
    assert tiles == list(range(-(-S // fa.KEY_TILE)))
    blocks = B * H * -(-R // fa.MMA_ROW_TILE)
    n_ref = fa.SPLIT_REF_KEYS // fa.KEY_TILE // span
    assert blocks * n_ref >= fa.SPLIT_TARGET_BLOCKS or n_ref >= fa.MAX_SPLIT
    # the GQA form's plan of the same grid counts 16-row tiles
    assert fa.plan_splits(B, H, R, S) == fa.plan_splits(
        B, H, R, S, False, False, 16, size)


def test_many_row_and_int8_d120_smem():
    """Shared memory a block asks for: the many-row form double-buffers
    32-key K and V tiles, rows padded to 16 bytes past a multiple of 128
    (bf16 D 120 first to 128 values), or holds the merge's 64 f32 rows
    with m, l and fold factors, whichever is more; the int8 form at D 120
    stages 120-byte int8 rows and bf16 views 128 values wide."""
    merge = lambda D: (64 * D + 2 * 64 + 64 * 16 * 2) * 4   # noqa: E731
    ring = 2 * 2 * 32                            # two K and V tiles
    assert fa.kernel_smem(128, 128, 4, many=True) == max(ring * 132 * 4,
                                                          merge(128))
    assert fa.kernel_smem(120, 120, 4, many=True) == max(ring * 132 * 4,
                                                          merge(120))
    assert fa.kernel_smem(64, 64, 4, many=True) == max(ring * 68 * 4,
                                                        merge(64))
    assert fa.kernel_smem(128, 128, 2, many=True) == max(ring * 136 * 2,
                                                          merge(128))
    assert fa.kernel_smem(120, 120, 2, 2, many=True) == max(ring * 136 * 2,
                                                             merge(120))
    assert fa.kernel_smem(64, 64, 2, many=True) == max(ring * 72 * 2,
                                                        merge(64))
    assert fa.kernel_smem(120, 120, 1) == 8 * 64 * 120 + 8 * 64 * 272
    for D in fa.MMA_HEADS:
        for size in (2, 4):
            assert fa.kernel_smem(D, D, size, many=True) <= 227 * 1024
    # the GQA form's tiles are unchanged
    assert fa.kernel_smem(120, 120, 4) == 2 * 2 * 32 * 120 * 4


# (B, Hkv, T, G, D, K/V dtype): decode, the tree's cache pass, a commit
# and a prefill at phase M's widths, the encoder, the drafters' widths
PLAN_CASES = [(4, 8, 1, 4, D, dt) for D, dt in ((120, torch.float32),
                                                (120, torch.int8))] + [
    (4, 8, 10, 4, 120, torch.bfloat16), (4, 8, 6, 4, 120, torch.float32),
    (1, 8, 512, 4, 120, torch.bfloat16), (1, 8, 512, 4, 120, torch.int8),
    (4, 8, 10, 4, 120, torch.int8), (1, 12, 150, 1, 64, torch.float32),
    (4, 2, 10, 7, 64, torch.bfloat16), (1, 20, 512, 1, 128, torch.float32),
    (2, 2, 33, 1, 32, torch.float32)]


def _recorder(calls):
    def fn(*args):
        # (..., n_split, span_tiles, v_in_k, row_tile, stream)
        calls.append((args[-5], args[-4], args[-2]))
        return 0
    return fn


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["-".join(str(x).replace("torch.", "")
                                       for x in c) for c in PLAN_CASES])
def test_resident_and_paged_wrappers_launch_the_same_plan(monkeypatch,
                                                          case):
    """Both wrappers launch the form, split and row tile that
    `launch_plan` gives for (B, Hkv, R = T G, S, D, dtype), the paged one
    with S = n_view x page_size: the same function of the same numbers,
    so the paged kernel is kernel 1 on the gathered view. Its launch
    counters (the many-row form's among them) move alike. Kernel 1 with
    a bool mask (a tree segment) launches the GQA form's plan."""
    B, H, T, G, D, dt = case
    ps, nv = 64, 16
    S = ps * nv
    calls = []
    for mod in (fa, pa):
        monkeypatch.setattr(mod, "_FN", _recorder(calls))
        monkeypatch.setattr(mod, "cuda_stream", lambda dev: 0)
        for name in ("LAUNCHES", "LAUNCHES_INT8_KV", "LAUNCHES_MANY_ROWS"):
            monkeypatch.setattr(mod, name, 0)
    int8 = dt == torch.int8
    q = torch.zeros((B, T, H, G, D))
    qpos = torch.zeros((B, T), dtype=torch.int32)

    def kv(lead):
        t = torch.zeros(lead + (H, D), dtype=dt)
        return t, (torch.ones(lead + (H,)) if int8 else None)

    (k, ks), (v, vs) = kv((B, S)), kv((B, S))
    fa._launch(q, k, v, qpos, torch.zeros((B, S), dtype=torch.int32),
               scale=1.0, causal=True, window=0, mask=None, slot_idx=None,
               k_scale=ks, v_scale=vs)
    (kp, ksp), (vp, vsp) = kv((B * nv, ps)), kv((B * nv, ps))
    pa._launch(q, kp, vp, qpos, torch.zeros((B * nv, ps), dtype=torch.int32),
               torch.arange(B * nv, dtype=torch.int32).reshape(B, nv),
               scale=1.0, window=0, k_scale=ksp, v_scale=vsp)
    n_split, span, rows, many = fa.launch_plan(B, H, T, G, S, D, D, dt)
    assert calls == [(n_split, span, rows)] * 2
    assert many == (not int8 and fa.many_rows(D, k.element_size(), T * G))
    assert rows == (64 if many or (int8 and T * G > 16) else 16)
    for mod in (fa, pa):
        assert (mod.LAUNCHES, mod.LAUNCHES_INT8_KV,
                mod.LAUNCHES_MANY_ROWS) == (1, int(int8), int(many))
    fa._launch(q, k, v, qpos, torch.zeros((B, S), dtype=torch.int32),
               scale=1.0, causal=True, window=0, slot_idx=None, k_scale=ks,
               v_scale=vs, mask=torch.ones((B, T, S), dtype=torch.bool))
    masked = fa.launch_plan(B, H, T, G, S, D, D, dt, masked=True)
    assert calls[-1] == masked[:3] and not masked[3]
    assert masked[:3] == (calls[0] if int8 else fa.plan_splits(B, H, T * G, S)
                          + (fa.ROW_TILE,))
    assert fa.LAUNCHES_MANY_ROWS == int(many)


def test_int8_at_d120_is_taken_with_8_byte_rows():
    """`check_pair` takes int8 K/V at D 120 (no ValueError): its rows are
    staged by 8-byte copies, so a head's 120-byte rows need 8-byte
    alignment (`kv_align`), and every other row 16-byte."""
    def check(cond, msg):
        if not cond:
            raise ValueError(msg() if callable(msg) else msg)

    for D in (16, 32, 64, 120, 128):
        fa.check_pair(check, D, D, torch.int8)
    with pytest.raises(ValueError, match="latent"):
        fa.check_pair(check, 576, 512, torch.int8)
    k8 = torch.zeros((3, 40, 8, 120), dtype=torch.int8)
    assert fa.kv_align(k8) == 8
    assert k8.stride(2) % 16 == 8 and fa.kv_aligned(k8, k8.stride()[:3])
    for t in (torch.zeros((3, 40, 8, 128), dtype=torch.int8),
              torch.zeros((3, 40, 8, 120), dtype=torch.bfloat16),
              torch.zeros((3, 40, 8, 120))):
        assert fa.kv_align(t) == 16
    # a 4-byte offset breaks the 8-byte rule; an 8-byte one does not
    flat = torch.zeros(3 * 40 * 8 * 120 + 8, dtype=torch.int8)
    base = flat.data_ptr() % 8
    for off, ok in ((4, False), (8, True)):
        s = (8 - base) % 8 + off
        t = flat[s: s + 3 * 40 * 8 * 120].view(3, 40, 8, 120)
        assert fa.kv_aligned(t, t.stride()[:3]) == ok
    # the bf16 rows at D 120 (240 bytes) keep the 16-byte rule
    kb = torch.zeros((3, 40, 8, 121), dtype=torch.bfloat16)[..., :120]
    assert not fa.kv_aligned(kb, kb.stride()[:3])


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _ref_layers(tcfg, jc):
    """The reference cache's self-attention leaves in the port's layer
    order (numpy)."""
    out = []
    for (pattern, reps), stage in zip(TM.layer_plan(tcfg), jc["stages"]):
        leaves = [jax.tree.map(np.asarray, stage[j])["self"]
                  for j in range(len(pattern))]
        for r in range(reps):
            out += [{k: v[r] for k, v in lv.items()} for lv in leaves]
    return out


def _step(monkeypatch, tcfg, tc, jc_after, run):
    """One port step that writes the reference's stored rows: `kv_rows`
    quantizes as always (kept for the caller to compare) and hands
    `set_rows` the int8 rows and scales the reference wrote at the same
    columns, so both caches stay equal and the logits compare the reads.
    Returns (port outputs, the port's own rows by layer)."""
    ref = _ref_layers(tcfg, jc_after)
    layer_of = {id(layer["self"]["k"]): i
                for i, layer in enumerate(tc["layers"])}
    own = {}
    orig = TA.kv_rows

    def kv_rows(cache, k_new, v_new, positions):
        rows = orig(cache, k_new, v_new, positions)
        i = layer_of[id(cache["k"])]
        own[i] = dict(rows, k_f32=k_new.float(), v_f32=v_new.float())
        col = (positions % cache["slot_pos"].shape[1]).long().numpy()
        b = np.arange(col.shape[0])[:, None]
        for key in ("k", "v", "k_scale", "v_scale"):
            rows[key] = torch.from_numpy(np.ascontiguousarray(
                ref[i][key][b, col]))
        return rows

    monkeypatch.setattr(TA, "kv_rows", kv_rows)
    out = run()
    monkeypatch.setattr(TA, "kv_rows", orig)
    for i, rows in own.items():
        col = (rows["slot_pos"] % tc["layers"][i]["self"]["slot_pos"].shape[1]
               ).long().numpy()
        b = np.arange(col.shape[0])[:, None]
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(rows[key].numpy(), ref[i][key][b, col],
                                       rtol=1e-5, atol=1e-8)
        for key in ("k", "v"):
            # the two frameworks' f32 K and V differ in their last bits:
            # a value lands one step away from the reference's only at a
            # rounding tie, x / scale within 1e-3 of a half step
            d = np.abs(rows[key].numpy().astype(np.int32)
                       - ref[i][key][b, col].astype(np.int32))
            x = np.abs((rows[key + "_f32"]
                        / rows[key + "_scale"][..., None]).numpy())
            assert d.max() <= 1, (i, key)
            assert np.all(np.abs(x - np.floor(x) - 0.5)[d > 0] < 1e-3), (
                i, key)
    return out


def test_danube_int8_kv_steps_match_jax(monkeypatch):
    """The reduced h2o-danube3-4b (head width 120, f32) with int8 KV
    caches: prefill, decode and a tree verification (no commit, its
    fresh segment unquantized) on a batch cache against the JAX
    package's int8 path. Each written row's scales are within 1e-5 of
    the reference's and its int8 values equal them but at rounding ties
    (the two frameworks' f32 K and V differ in the last bits, and a tie
    rounds either way, one step of the scale); the port then stores the
    reference's rows (`_step`), so the logits compare the int8 reads at
    D 120 from equal caches: 1e-4; positions and lengths equal."""
    cfg = ARCHS["h2o-danube3-4b"].reduced().with_overrides(
        head_dim=120, dtype="float32", kv_dtype="int8")
    tcfg = _tcfg(cfg)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tp = params_from_numpy(tree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    B, cap = 2, 48
    jc = JM.init_cache(cfg, B, cap, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, cap, dtype=torch.float32, device="cpu")
    assert tc["layers"][0]["self"]["k"].shape[-1] == 120
    assert tc["layers"][0]["self"]["k"].dtype == torch.int8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, 20)).astype(np.int32)
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = _step(monkeypatch, tcfg, tc, jc, lambda: TM.prefill(
        tp, tcfg, torch.tensor(toks), tc))
    _close(lt, lj)
    step = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(step), jc)
    lt, tc, _ = _step(monkeypatch, tcfg, tc, jc, lambda: TM.decode_step(
        tp, tcfg, torch.tensor(step), tc))
    _close(lt, lj)
    G = 4
    mask = np.tril(np.ones((G, G), bool))
    mask[3, 1:3] = False                     # node 3 hangs off node 0
    pos = np.asarray(jc["lengths"])[:, None] + np.array([0, 1, 2, 1])
    vt = rng.integers(0, cfg.vocab, (B, G)).astype(np.int32)
    seg = np.broadcast_to(mask, (B, G, G))
    lj, _, _ = JM.verify_chunk(jp, cfg, jnp.asarray(vt), jc,
                               positions=jnp.asarray(pos, jnp.int32),
                               seg_mask=jnp.asarray(seg))
    lt, _, _ = TM.verify_chunk(tp, tcfg, torch.tensor(vt), tc,
                               positions=torch.tensor(pos, dtype=torch.int32),
                               seg_mask=torch.tensor(seg.copy()))
    _close(lt, lj)
    _eq(tc["lengths"], jc["lengths"])
    for tl, jl in zip((layer["self"] for layer in tc["layers"]),
                      _ref_layers(tcfg, jc)):
        for key in ("slot_pos", "k", "v", "k_scale", "v_scale"):
            _eq(tl[key], jl[key])
