"""The port's flash-attention kernel module against the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the Pallas kernel `repro.kernels.common.flash_attention_partial`
in interpret mode (the (acc, m, l) partials and their merge) and against
the reference oracles `tree_attention_ref`, `decode_attention_ref` and
`decode_attention_slots_ref`, over the same shape sweeps as
`tests/test_kernels.py`. Inputs come from numpy with a fixed seed and go
to both frameworks. Tolerances are those of `tests/test_kernels.py`:
2e-5 in float32 and 2e-2 in bfloat16 (f32 summation order differs; bf16
inputs round identically on both sides).

The CUDA kernel itself is held against the plain version on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from repro.kernels.common import flash_attention_partial as jax_partial
from repro.kernels.common import merge_partials as jax_merge
from repro.kernels.decode_attention.ref import (decode_attention_ref,
                                                decode_attention_slots_ref)
from repro.kernels.tree_attention.ref import tree_attention_ref
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.flash_attention import ops as fa
from test_kernels import DECODE_CASES, TREE_CASES


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield



def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    if dtype == jnp.bfloat16:
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.tensor(x)


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 2e-5


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the reference's kernel-layout compositions, built on the port's wrapper
# as the model uses it

def _tree_attention(q, k_cache, v_cache, cache_pos, k_seg, v_seg, q_pos,
                    seg_mask, *, scale, window=0):
    """Two launches (cache, then the segment under its ancestor mask) and
    a merge, as `repro/kernels/tree_attention/ops.py` does it."""
    hist = fa.flash_attention_partial(q, k_cache, v_cache, q_pos, cache_pos,
                                      scale=scale, causal=True, window=window)
    seg_pos = torch.zeros(k_seg.shape[0], k_seg.shape[2], dtype=torch.int32)
    seg = fa.flash_attention_partial(q, k_seg, v_seg, q_pos, seg_pos,
                                     scale=scale, causal=False, mask=seg_mask)
    return fa.merge_partials([hist, seg])


def _decode_attention_slots(q, k_cache, v_cache, cache_pos, q_pos, slot_idx,
                            *, scale, window=0):
    """One token's G rows per KV head, q (B, Hkv, G, Dk), over a cache
    (P, Hkv, C, D) read through slot_idx (or P = B with slot_idx None)."""
    m, l, acc = fa.attend_partial(
        q.unsqueeze(1), k_cache.permute(0, 2, 1, 3),
        v_cache.permute(0, 2, 1, 3), q_pos[:, None], cache_pos, scale=scale,
        causal=True, window=window, slot_idx=slot_idx)
    return fa.finalize((m, l, acc))[:, 0]


PARTIAL_CASES = [
    # (B, H, R, S, Dk, Dv, causal, window, with_mask, empty_row, dtype)
    (1, 1, 4, 16, 16, 16, True, 0, False, False, jnp.float32),
    (2, 2, 12, 40, 32, 16, True, 0, True, False, jnp.float32),
    (2, 1, 16, 64, 64, 64, True, 24, False, False, jnp.float32),
    (2, 3, 8, 20, 32, 32, False, 0, True, True, jnp.float32),
    (1, 4, 8, 100, 128, 128, True, 0, True, False, jnp.bfloat16),
]


@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_partials_match_pallas_interpret(case):
    """(acc, m, l) and the merged output against the Pallas kernel in
    interpret mode; `empty_row` makes batch row 0 fully masked, which
    must give l = 0 and a merged output of 0 on both sides."""
    B, H, R, S, Dk, Dv, causal, window, with_mask, empty, dtype = case
    qj, qt = _pair(_np(1, (B, H, R, Dk)), dtype)
    kj, kt = _pair(_np(2, (B, H, S, Dk)), dtype)
    vj, vt = _pair(_np(3, (B, H, S, Dv)), dtype)
    kpos = np.where(np.arange(S) < S - 5, np.arange(S), -1)
    kpos = np.broadcast_to(kpos, (B, S)).astype(np.int32).copy()
    if empty:
        kpos[0] = -1
    qpos = (S - 5 + np.arange(R) // 2 - R // 4)[None].repeat(B, 0)
    qpos = qpos.astype(np.int32)
    mask = None
    if with_mask:
        mask = np.random.default_rng(4).random((B, R, S)) < 0.6
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    acc_j, m_j, l_j = jax_partial(
        qj, kj, vj, jnp.asarray(qpos), jnp.asarray(kpos), scale=0.2,
        causal=causal, window=window, mask=jm, block_q=8, block_k=16,
        interpret=True)
    acc_t, m_t, l_t = fa.flash_attention_partial(
        qt, kt, vt, torch.tensor(qpos), torch.tensor(kpos), scale=0.2,
        causal=causal, window=window, mask=tm)
    tol = _tol(dtype)
    _close(acc_t, acc_j, tol)
    _close(m_t, m_j, tol)
    _close(l_t, l_j, tol)
    out_j = jax_merge([(acc_j, m_j, l_j)])
    out_t = fa.merge_partials([(acc_t, m_t, l_t)])
    _close(out_t, out_j, tol)
    if empty:
        assert float(l_t[0].abs().max()) == 0.0
        assert float(out_t[0].abs().max()) == 0.0


@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_attention_matches_ref(case):
    """Two passes (cache, segment under the tree mask) and a merge."""
    B, H, R, S, Msz, Dk, Dv, window, dtype = case
    qj, qt = _pair(_np(1, (B, H, R, Dk)), dtype)
    kcj, kct = _pair(_np(2, (B, H, S, Dk)), dtype)
    vcj, vct = _pair(_np(3, (B, H, S, Dv)), dtype)
    ksj, kst = _pair(_np(4, (B, H, Msz, Dk)), dtype)
    vsj, vst = _pair(_np(5, (B, H, Msz, Dv)), dtype)
    n_valid = max(S - 7, 1)
    cp = np.where(np.arange(S) < n_valid, np.arange(S), -1)
    cp = np.broadcast_to(cp, (B, S)).astype(np.int32)
    qp = (n_valid + np.arange(R) // 2)[None].repeat(B, 0).astype(np.int32)
    mask = np.random.default_rng(6).random((B, R, Msz)) < 0.5
    mask |= np.arange(R)[:, None] == np.arange(Msz)[None, :]
    ref = tree_attention_ref(qj, kcj, vcj, jnp.asarray(cp), ksj, vsj,
                             jnp.asarray(qp), jnp.asarray(mask), scale=0.18,
                             window=window)
    out = _tree_attention(qt, kct, vct, torch.tensor(cp), kst, vst,
                          torch.tensor(qp), torch.tensor(mask), scale=0.18,
                          window=window)
    _close(out, ref, _tol(dtype))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_ref(case):
    B, H, G, S, D, window, dtype = case
    qj, qt = _pair(_np(1, (B, H, G, D)), dtype)
    kj, kt = _pair(_np(2, (B, H, S, D)), dtype)
    vj, vt = _pair(_np(3, (B, H, S, D)), dtype)
    cp = np.where(np.arange(S) < S - 3, np.arange(S), -1)
    cp = np.broadcast_to(cp, (B, S)).astype(np.int32)
    qp = np.full((B,), S - 3, np.int32)
    ref = decode_attention_ref(qj, kj, vj, jnp.asarray(cp), jnp.asarray(qp),
                               scale=0.2, window=window)
    out = _decode_attention_slots(qt, kt, vt, torch.tensor(cp),
                                  torch.tensor(qp), None, scale=0.2,
                                  window=window)
    _close(out, ref, _tol(dtype))


@pytest.mark.parametrize("repeated_scratch", [False, True])
@pytest.mark.parametrize("case", DECODE_CASES[:3])
def test_decode_attention_slots_matches_ref(case, repeated_scratch):
    """Slot-indexed reads of a pool larger than the batch, in place; with
    `repeated_scratch` two rows read the same scratch slot 0."""
    B, H, G, S, D, window, dtype = case
    pool = B + 3
    qj, qt = _pair(_np(1, (B, H, G, D)), dtype)
    kj, kt = _pair(_np(2, (pool, H, S, D)), dtype)
    vj, vt = _pair(_np(3, (pool, H, S, D)), dtype)
    cp = np.where(np.arange(S) < S - 3, np.arange(S), -1)
    cp = np.broadcast_to(cp, (pool, S)).astype(np.int32)
    qp = np.full((B,), S - 3, np.int32)
    slot_idx = (np.arange(B) * 2 + 1) % pool
    if repeated_scratch:
        slot_idx = np.concatenate([slot_idx[:1], [0, 0]])
        qj, qt = _pair(_np(1, (3, H, G, D)), dtype)
        qp = np.full((3,), S - 3, np.int32)
    slot_idx = slot_idx.astype(np.int32)
    ref = decode_attention_slots_ref(
        qj, kj, vj, jnp.asarray(cp), jnp.asarray(qp), jnp.asarray(slot_idx),
        scale=0.2, window=window)
    out = _decode_attention_slots(
        qt, kt, vt, torch.tensor(cp), torch.tensor(qp),
        torch.tensor(slot_idx), scale=0.2, window=window)
    _close(out, ref, _tol(dtype))


def test_wrapper_reads_model_layout_views():
    """The model-layout wrapper on strided views (a slot pool in the
    model's (P, C, Hkv, D) layout, GQA rows t * G + g) equals the
    kernel-layout contract on gathered, transposed copies."""
    B, T, H, G, D, P, C = 2, 3, 2, 3, 16, 5, 24
    q = torch.tensor(_np(1, (B, T, H, G, D)))
    k = torch.tensor(_np(2, (P, C, H, D)))
    v = torch.tensor(_np(3, (P, C, H, D)))
    kpos = torch.tensor(np.where(np.arange(C) < 20, np.arange(C), -1)
                        [None].repeat(P, 0).astype(np.int32))
    qpos = torch.tensor(np.array([[17, 18, 19]] * B, np.int32))
    slot_idx = torch.tensor([3, 1], dtype=torch.int32)
    m, l, acc = fa.attend_partial(q, k, v, qpos, kpos, scale=0.25,
                                  slot_idx=slot_idx)
    idx = slot_idx.long()
    qk = q.permute(0, 2, 1, 3, 4).reshape(B, H, T * G, D)
    acc2, m2, l2 = fa.flash_attention_partial(
        qk, k[idx].permute(0, 2, 1, 3), v[idx].permute(0, 2, 1, 3),
        qpos.repeat_interleave(G, dim=1), kpos[idx], scale=0.25)
    _close(acc.permute(0, 2, 1, 3, 4).reshape(B, H, T * G, D), acc2, 1e-6)
    _close(m.permute(0, 2, 1, 3).reshape(B, H, T * G), m2, 1e-6)
    _close(l.permute(0, 2, 1, 3).reshape(B, H, T * G), l2, 1e-6)


# the kernel's split-K plan: (B, Hkv, R, S) at the serving shapes (qwen
# drafter decode, target cache pass, segment pass, prefill; jamba decode
# and chain verification) and at ragged edges
SPLIT_SHAPES = [(4, 2, 7, 1024), (4, 20, 10, 1024), (4, 20, 10, 10),
                (1, 20, 512, 1024), (4, 8, 4, 1024), (4, 8, 24, 1024),
                (1, 1, 7, 300), (3, 2, 80, 2048), (2, 1, 1, 16), (1, 1, 1, 1),
                (5, 3, 33, 999)]


@pytest.mark.parametrize(
    "B,H,R,S,int8", [(*sh, False) for sh in SPLIT_SHAPES]
    + [(*sh, True) for sh in SPLIT_SHAPES],
    ids=["-".join(map(str, sh)) for sh in SPLIT_SHAPES]
    + ["int8-" + "-".join(map(str, sh)) for sh in SPLIT_SHAPES])
def test_split_plan_covers_every_key_tile_once(B, H, R, S, int8):
    """The blocks of a cluster walk spans of whole 32-key tiles, in rank
    order, that cover the S logical keys exactly once, as the kernel
    numbers them (rank r's i-th tile is (r + n (i // span)) span +
    i % span); the span comes from the grid alone, never from S, and
    meets the block target at the reference capacity unless the cluster
    limit stops it: for the GQA form and the int8 K/V form (its row tile
    from R, its own target)."""
    n, span = fa.plan_splits(B, H, R, S, False, int8)
    assert 1 <= n <= fa.MAX_SPLIT and n & (n - 1) == 0 and span >= 1
    assert span == fa.plan_splits(B, H, R, 4 * S + 7, False, int8)[1]
    n_tiles = -(-S // fa.KEY_TILE)
    ranges = fa.split_ranges(S, n, span)
    assert len(ranges) == n
    tiles = []
    for r, keys in enumerate(ranges):
        mine = [t for lo, hi in keys
                for t in range(lo // fa.KEY_TILE, -(-hi // fa.KEY_TILE))]
        assert all(lo % fa.KEY_TILE == 0 and lo < hi for lo, hi in keys)
        assert mine == [(r + n * (i // span)) * span + i % span
                        for i in range(len(mine))]
        tiles += mine
    assert sorted(tiles) == list(range(n_tiles))
    n_ref = fa.SPLIT_REF_KEYS // fa.KEY_TILE // span
    rows = fa.tiling(False, int8, R)[2]
    target = fa.INT8_SPLIT_TARGET_BLOCKS if int8 else fa.SPLIT_TARGET_BLOCKS
    assert (B * H * -(-R // rows) * n_ref >= target
            or n_ref >= fa.MAX_SPLIT)


# phase K's int8 K/V reads (chip_smoke.py): (B, Hkv, R) of the target
# (Hkv 20, G 1) and the drafters (Hkv 2, G 7) at decode, the tree's cache
# pass (T 10), a T = 6 commit and a T = 512 prefill, over a 1024-key pool,
# with the (n_split, span, row tile) each gets
INT8_PLANS = [((4, 20, 1), (1, 32, 16)), ((4, 20, 10), (1, 32, 16)),
              ((4, 20, 6), (1, 32, 16)), ((1, 20, 512), (1, 32, 64)),
              ((4, 2, 7), (8, 4, 16)), ((4, 2, 70), (4, 8, 64)),
              ((4, 2, 42), (8, 4, 64)), ((1, 2, 3584), (1, 32, 64))]


@pytest.mark.parametrize("grid,plan", INT8_PLANS)
def test_int8_plan_at_phase_k_shapes(grid, plan):
    """The int8 K/V form's plan at the serving shapes: 16 query rows a
    block up to R = 16, else 64; its own block target (one 8-warp block
    fills an SM); the same span for a page pool's view of 128 keys, so
    pools of other capacities sum the same spans in the same order."""
    B, H, R = grid
    n, span = fa.plan_splits(B, H, R, fa.SPLIT_REF_KEYS, False, True)
    rows = fa.tiling(False, True, R)[2]
    assert (n, span, rows) == plan
    assert B * H * -(-R // rows) * n >= fa.INT8_SPLIT_TARGET_BLOCKS or \
        n * span * fa.KEY_TILE >= fa.SPLIT_REF_KEYS
    assert fa.plan_splits(B, H, R, 128, False, True)[1] == span


def test_attention_kernel_smem_in_budget():
    """Every instantiation's dynamic shared memory fits a block on the
    H100 and holds the merge's (row tile, Dv) f32 rows, at every (Dk, Dv)
    pair the kernels are built for: the GQA form's K/V double buffer,
    the int8 form's ring of int8 tiles and bf16 views (holding the
    merge's rows of its largest row tile, 64) and the latent form's 64
    rows of q, two
    tile buffers and score tiles, at f32 and bf16 q (a `gpu` test holds
    it, with the static part, against the compiled kernels)."""
    assert (576, 512) in fa.SUPPORTED_PAIRS
    for Dk, Dv in fa.SUPPORTED_PAIRS:
        for size in ((1, 2, 4) if Dk == Dv else (2, 4)):
            rows = fa.tiling(Dk != Dv, size == 1, 64)[2]
            for q_size in (2, 4):
                dynamic = fa.kernel_smem(Dk, Dv, size, q_size)
                assert rows * Dv * 4 <= dynamic <= SMEM_LIMIT
    # the int8 form: 8 stages of 32 int8 K and V rows, and 8 bf16 views
    # of 32 K and V rows (2 D + 16 bytes a row)
    assert fa.kernel_smem(128, 128, 1) == 8 * 64 * 128 + 8 * 64 * 272
    assert fa.kernel_smem(64, 64, 1) == 8 * 64 * 64 + 8 * 64 * 144
    assert fa.kernel_smem(16, 16, 1) == 8 * 64 * 16 + 8 * 64 * 48


def _split_merged(q, k, v, qpos, kpos, mask, scale, window, slot_idx):
    """The plain version over each block's keys (its spans in order),
    merged in rank order with `merge_two`: the kernel's arithmetic."""
    B, T, H, G, _ = q.shape
    S = k.shape[1]
    n, span = fa.plan_splits(B, H, T * G, S)
    state = None
    for keys in fa.split_ranges(S, n, span):
        idx = torch.cat([torch.arange(lo, hi) for lo, hi in keys]
                        or [torch.zeros(0, dtype=torch.long)])
        part = fa.attend_partial_plain(
            q, k[:, idx], v[:, idx], qpos, kpos[:, idx], scale=scale,
            window=window, slot_idx=slot_idx, block=fa.KEY_TILE,
            mask=None if mask is None else mask[:, :, idx])
        state = part if state is None else fa.merge_two(state, part)
    return n, state


@pytest.mark.parametrize("window,with_mask", [(0, False), (40, False),
                                              (0, True)])
def test_split_merge_equals_unsplit_plain(window, with_mask):
    """Split ranges merged in rank order equal the unsplit plain version
    within 1e-6 (f32 summation order): a slot pool with an empty slot
    (l = 0), a window that empties whole splits, a tree-like mask, S not
    a multiple of the split."""
    B, T, H, G, D, P, S = 3, 2, 2, 3, 16, 4, 300
    q = torch.tensor(_np(1, (B, T, H, G, D)))
    k = torch.tensor(_np(2, (P, S, H, D)))
    v = torch.tensor(_np(3, (P, S, H, D)))
    kpos = np.where(np.arange(S) < 250, np.arange(S), -1)[None].repeat(P, 0)
    kpos[2] = -1
    kpos = torch.tensor(kpos.astype(np.int32))
    qpos = torch.tensor(np.array([[240, 241]] * B, np.int32))
    slot_idx = torch.tensor([3, 2, 0], dtype=torch.int32)
    mask = (torch.tensor(np.random.default_rng(4).random((B, T, S)) < 0.7)
            if with_mask else None)
    n, got = _split_merged(q, k, v, qpos, kpos, mask, 0.25, window,
                           slot_idx)
    assert n == 8
    want = fa.attend_partial_plain(q, k, v, qpos, kpos, scale=0.25,
                                   window=window, slot_idx=slot_idx,
                                   block=fa.KEY_TILE, mask=mask)
    for a, b in zip(got, want):
        _close(a, b, 1e-6)
    assert float(got[1][1].abs().max()) == 0.0      # slot 2 is empty: l = 0


def test_split_merge_matches_pallas_interpret():
    """The split-and-merge arithmetic against the JAX package's Pallas
    kernel (interpret mode) over all keys, normalised by
    `merge_partials`: the kernel's tolerance, 1e-4."""
    B, H, R, S, D = 2, 2, 6, 200, 16
    qn = _np(1, (B, H, R, D))
    kn, vn = _np(2, (B, H, S, D)), _np(3, (B, H, S, D))
    kpos = np.where(np.arange(S) < 190, np.arange(S), -1)
    kpos = np.broadcast_to(kpos, (B, S)).astype(np.int32).copy()
    qpos = np.full((B, R), 189, np.int32)
    acc_j, m_j, l_j = jax_partial(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(qpos),
        jnp.asarray(kpos), scale=0.25, causal=True, block_q=8, block_k=16,
        interpret=True)
    out_j = jax_merge([(acc_j, m_j, l_j)])
    # the kernel layout (B, Hkv, R, D) as the port's (B, T=R, Hkv, G=1, D)
    qt = torch.tensor(qn).permute(0, 2, 1, 3).unsqueeze(3)
    n, (m, l, acc) = _split_merged(qt, torch.tensor(kn).permute(0, 2, 1, 3),
                              torch.tensor(vn).permute(0, 2, 1, 3),
                              torch.tensor(qpos), torch.tensor(kpos), None,
                              0.25, 0, None)
    out_t = fa.finalize((m, l, acc))[:, :, :, 0].permute(0, 2, 1, 3)
    assert n == 4
    _close(out_t, out_j, 1e-4)


def test_split_merge_bits_do_not_depend_on_capacity():
    """A slot pool of 1024 keys and a 128-key view holding the same keys
    (as a page pool's gathered view does) give the same bits: the span is
    the same, and the extra blocks hold no live key, which the merge
    passes through exactly. Phase C's streams equal phase A's by this."""
    B, T, H, G, D, S = 1, 1, 1, 7, 16, 1024
    q = torch.tensor(_np(1, (B, T, H, G, D)))
    k = torch.tensor(_np(2, (B, S, H, D)))
    v = torch.tensor(_np(3, (B, S, H, D)))
    kpos = torch.tensor(np.where(np.arange(S) < 100, np.arange(S), -1)
                        [None].astype(np.int32))
    qpos = torch.tensor([[99]], dtype=torch.int32)
    n1, full = _split_merged(q, k, v, qpos, kpos, None, 0.25, 0, None)
    n2, view = _split_merged(q, k[:, :128], v[:, :128], qpos, kpos[:, :128],
                             None, 0.25, 0, None)
    assert (n1, n2) == (16, 2)
    for a, b in zip(full, view):
        assert torch.equal(a, b)


def test_kernel_library_builds_once_under_threads(tmp_path, monkeypatch):
    """Four threads' first builds of one kernel library (the async
    backend's server and engine threads may both call a wrapper first)
    run the compiler once and all get its library. A stand-in `nvcc`
    records each run and writes its `-o` file after a pause."""
    import sys
    import threading

    from repro_torch.kernels import build

    runs = tmp_path / "runs"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys, time\n"
                    f"open({str(runs)!r}, 'a').write('x')\n"
                    "time.sleep(0.3)\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w')"
                    ".write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    src = tmp_path / "probe.cu"
    src.write_text("// a kernel source\n")
    lib = build.KernelLibrary("probe", src)
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib.build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert runs.read_text() == "x"
    assert len(got) == 4 and len(set(got)) == 1
    assert got[0] == lib.library_path() and got[0].read_text() == "lib"
