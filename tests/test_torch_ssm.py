"""The port's SSM path against `repro`: the SSD scan, the Mamba2 mixer and
the SSM and hybrid models, on the CPU.

* The scan's plain version (what `kernels/ssd_scan/ops.py::ssd` runs on
  CPU tensors) against three references on the same numpy inputs: the
  JAX `ssd_chunked`, the Pallas `ssd_scan.ops.ssd` in interpret mode and
  the recurrence `ssd_reference`, over `SSD_CASES` of
  `tests/test_kernels.py` plus L = 1, a ragged L, an initial state and a
  dt = 0 tail, at rtol = atol = 2e-4 (the reference's own tolerance: f32
  sums in another order and another chunking).
* The in-place entry `ssd_slots` (plain version) against the same
  references with its initial state gathered from a scrambled slot pool;
  write=False leaves the pool bitwise unchanged, write=True changes only
  the named rows, and the result does not depend on the pool's capacity.
* The kernel's `plan` (plain Python): the recurrence up to
  `rec_max_l(N)` tokens, the chunk path above; its P-slices cover P exactly and its
  shared memory fits the H100's limit.
* `ssm_mixer` against the JAX mixer without state, on a slot pool, with
  a token mask and with write=False, at f32 and bf16 activations
  (1e-4 at f32; bf16 inputs, f32 arithmetic after the promoting
  in_proj product: 1e-4 as well).
* The tiny SSM and hybrid models against `repro.models.model.apply` at
  f32 (logits and SSM state within 1e-4, positions and lengths equal)
  across prefill, decode, chain verification, extend and the slot steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.kernels.ssd_scan.ops import ssd as jax_ssd_pallas
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import config as tconfig
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


SSD_TOL = 2e-4
TOL = 1e-4
MAX_LEN = 40


def _tcfg(cfg):
    return tconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})


def _close(t, j, tol=TOL):
    t = t.detach().float().numpy() if torch.is_tensor(t) else t
    np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- the scan

# (b, L, H, P, G, N, chunk): SSD_CASES of tests/test_kernels.py, then
# decode (L = 1), a ragged L with G = H, and the mamba2 head layout
SSD_CASES = [
    (1, 16, 2, 8, 1, 8, 8),
    (2, 50, 8, 16, 2, 8, 16),
    (2, 33, 4, 32, 4, 16, 8),
    (1, 64, 8, 64, 1, 32, 32),
    (3, 1, 4, 16, 2, 8, 16),
    (2, 37, 3, 8, 3, 4, 16),
    (1, 70, 2, 64, 1, 128, 64),
]


def _ssd_inputs(case, seed, init=True):
    b, L, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B = rng.standard_normal((b, L, G, N)).astype(np.float32)
    C = rng.standard_normal((b, L, G, N)).astype(np.float32)
    s0 = (rng.standard_normal((b, H, P, N)).astype(np.float32) * 0.1
          if init else None)
    return x, dt, A, B, C, s0


def _port_ssd(args, chunk):
    x, dt, A, B, C, s0 = (None if a is None else torch.from_numpy(a)
                          for a in args)
    return ssd_ops.ssd(x, dt, A, B, C, chunk, s0)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_three_references(case, init):
    args = _ssd_inputs(case, seed=sum(case), init=init)
    chunk = case[-1]
    y, s = _port_ssd(args, chunk)
    assert ssd_ops.LAUNCHES == 0            # CPU tensors never launch
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    refs = [JS.ssd_chunked(*jargs[:5], chunk, jargs[5]),
            jax_ssd_pallas(*jargs[:5], chunk=chunk, initial_state=jargs[5],
                           interpret=True),
            JS.ssd_reference(*jargs[:5], initial_state=jargs[5])]
    for yr, sr in refs:
        _close(y, yr, SSD_TOL)
        _close(s, sr, SSD_TOL)
    # the port's own recurrence oracle is the reference's
    yt, st = TS.ssd_reference(*(None if a is None else torch.from_numpy(a)
                                for a in args[:5]),
                              initial_state=None if args[5] is None
                              else torch.from_numpy(args[5]))
    _close(yt, refs[2][0], SSD_TOL)
    _close(st, refs[2][1], SSD_TOL)


def test_ssd_masked_tail_leaves_state_unchanged():
    """A dt = 0 suffix (masked tokens) decays by exp(0) = 1 and adds
    nothing: the final state and the real tokens' y are those of the
    real prefix alone, in both packages."""
    case = (2, 45, 4, 16, 2, 8, 16)
    x, dt, A, B, C, s0 = _ssd_inputs(case, seed=5)
    n_real = 29
    dt_m = dt.copy()
    dt_m[:, n_real:] = 0.0
    y, s = _port_ssd((x, dt_m, A, B, C, s0), 16)
    yp, sp = _port_ssd((x[:, :n_real], dt[:, :n_real], A, B[:, :n_real],
                        C[:, :n_real], s0), 16)
    _close(s, sp.numpy(), SSD_TOL)
    _close(y[:, :n_real], yp.numpy(), SSD_TOL)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt_m, A, B, C)), 16,
                            jnp.asarray(s0))
    _close(y, jy, SSD_TOL)
    _close(s, js, SSD_TOL)


def test_ssd_chunk_length_changes_only_summation_order():
    """The kernel scans in chunks of its own (`plan(...).q`), the plain
    version in cfg.chunk_size: the two chunkings agree to f32 order."""
    case = (1, 300, 4, 64, 1, 128, 128)
    args = _ssd_inputs(case, seed=11)
    q = ssd_ops.plan(1, 300, 4, 64, 1, 128, torch.float32).q
    assert q == 64
    y1, s1 = _port_ssd(args, 128)
    y2, s2 = _port_ssd(args, q)
    _close(y1, y2.numpy(), SSD_TOL)
    _close(s1, s2.numpy(), SSD_TOL)


@pytest.mark.parametrize("P,N,L,Q", [(64, 128, 512, 64), (64, 128, 1, 16),
                                     (64, 16, 512, 64), (64, 16, 5, 16),
                                     (128, 256, 512, 32)])
def test_kernel_chunk_fits_shared_memory(P, N, L, Q):
    """The plan's chunk (chunk path) or staged tokens (recurrence) at the
    served shapes (mamba2-130m P 64 N 128, jamba P 64 N 16) and a large
    state, f32: the tiles fit the dynamic shared memory a block may ask
    for, and at the served widths the chunk path's blocks all run at
    once."""
    p = ssd_ops.plan(1, L, 24, P, 1, N, torch.float32)
    assert p.path == ("rec" if L <= ssd_ops.rec_max_l(N) else "chunk")
    assert p.q == Q
    assert p.smem <= SMEM_LIMIT
    if p.path == "chunk" and N <= 128:
        assert (P // p.pb) * 24 <= ssd_ops.N_SM * _blocks_per_sm(p)


def test_ssd_wrapper_refuses_other_devices():
    x = torch.zeros((1, 2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_ops.ssd(x, x[..., 0], x[0, 0, :, 0], x, x, 16)


def _pool_case(case, seed, rows):
    """Scan inputs and a (rows, H, P, N) state pool whose named slots are
    scrambled over it (numpy)."""
    x, dt, A, B, C, _ = _ssd_inputs(case, seed, init=False)
    b, _, H, P, _, N, _ = case
    rng = np.random.default_rng(seed + 1)
    pool = (0.1 * rng.standard_normal((rows, H, P, N))).astype(np.float32)
    sidx = rng.permutation(rows)[:b].astype(np.int32)
    return (x, dt, A, B, C), pool, sidx


SLOT_CASES = [(3, 1, 4, 16, 2, 8, 16), (2, 6, 8, 16, 2, 8, 16),
              (2, 50, 8, 16, 2, 8, 16), (1, 70, 2, 64, 1, 128, 64)]


@pytest.mark.parametrize("case", SLOT_CASES)
def test_ssd_slots_plain_matches_references(case):
    """The in-place entry's plain version (what `ssd_slots` runs on CPU
    tensors): y and the rows it writes against the JAX Pallas `ssd`
    (interpret mode) and `ssd_reference` started from the gathered rows,
    at 2e-4 (f32 sums in another order)."""
    args, pool, sidx = _pool_case(case, sum(case), rows=7)
    state = torch.from_numpy(pool.copy())
    y = ssd_ops.ssd_slots(*map(torch.from_numpy, args), case[-1], state,
                          torch.from_numpy(sidx))
    assert ssd_ops.LAUNCHES == 0
    jargs = [jnp.asarray(a) for a in args]
    init = jnp.asarray(pool[sidx])
    for yr, sr in (jax_ssd_pallas(*jargs, chunk=case[-1], initial_state=init,
                                  interpret=True),
                   JS.ssd_reference(*jargs, initial_state=init)):
        _close(y, yr, SSD_TOL)
        _close(state[torch.from_numpy(sidx).long()], sr, SSD_TOL)


@pytest.mark.parametrize("write", [False, True])
def test_ssd_slots_writes_only_named_rows(write):
    """write=False leaves the whole pool bitwise unchanged; write=True
    replaces exactly the named rows (with ssd's final state) and leaves
    every other row bitwise as it was. y is the same either way."""
    case = (3, 9, 4, 16, 2, 8, 16)
    args, pool, sidx = _pool_case(case, 21, rows=8)
    targs = list(map(torch.from_numpy, args))
    state = torch.from_numpy(pool.copy())
    y = ssd_ops.ssd_slots(*targs, 16, state, torch.from_numpy(sidx),
                          write=write)
    want_y, want_s = ssd_ops.ssd(*targs, 16, torch.from_numpy(pool[sidx]))
    assert torch.equal(y, want_y)
    others = [r for r in range(8) if r not in sidx]
    assert np.array_equal(state[others].numpy(), pool[others])
    if write:
        assert torch.equal(state[torch.from_numpy(sidx).long()], want_s)
    else:
        assert np.array_equal(state.numpy(), pool)


def test_ssd_slots_does_not_depend_on_pool_capacity():
    """The plan takes no capacity and no slot indices, and the same rows
    in pools of 5 and 12 slots (at other indices) give bitwise equal y
    and final rows."""
    import inspect
    assert list(inspect.signature(ssd_ops.plan).parameters) == [
        "b", "L", "H", "P", "G", "N", "dtype"]
    case = (2, 20, 4, 16, 2, 8, 16)
    args, pool, _ = _pool_case(case, 8, rows=5)
    targs = list(map(torch.from_numpy, args))
    small = torch.from_numpy(pool.copy())
    big = torch.zeros((12, *pool.shape[1:]))
    big[[9, 4]] = small[[1, 3]]
    y1 = ssd_ops.ssd_slots(*targs, 16, small, torch.tensor([1, 3],
                                                            dtype=torch.int32))
    y2 = ssd_ops.ssd_slots(*targs, 16, big, torch.tensor([9, 4],
                                                          dtype=torch.int32))
    assert torch.equal(y1, y2)
    assert torch.equal(small[[1, 3]], big[[9, 4]])


@pytest.mark.parametrize("write", [False, True])
def test_ssd_slots_without_slots_takes_the_first_rows(write):
    """No slot_idx: request b reads row b of a pool with more rows than
    requests, and with `write` only the first b rows change; a slot
    outside the pool raises (the kernel stops on one)."""
    case = (2, 12, 4, 16, 2, 8, 16)
    args, pool, _ = _pool_case(case, 5, rows=5)
    targs = list(map(torch.from_numpy, args))
    state = torch.from_numpy(pool.copy())
    y = ssd_ops.ssd_slots(*targs, 16, state, write=write)
    want_y, want_s = ssd_ops.ssd(*targs, 16, torch.from_numpy(pool[:2]))
    assert torch.equal(y, want_y)
    assert np.array_equal(state[2:].numpy(), pool[2:])
    assert torch.equal(state[:2], want_s if write
                       else torch.from_numpy(pool[:2]))
    with pytest.raises(IndexError):
        ssd_ops.ssd_slots(*targs, 16, state,
                          torch.tensor([1, 5], dtype=torch.int32))


def test_ssd_slots_without_state_starts_from_zeros():
    """state=None: the scan starts from zeros and writes nothing (the
    self-contained mixer)."""
    case = (2, 12, 4, 16, 2, 8, 16)
    args, _, _ = _pool_case(case, 3, rows=2)
    targs = list(map(torch.from_numpy, args))
    y = ssd_ops.ssd_slots(*targs, 16, None)
    assert torch.equal(y, ssd_ops.ssd(*targs, 16)[0])


PLAN_SHAPES = [(b, L, H, P, N) for b in (1, 4) for L in (1, 6, 16, 17, 77,
                                                           512)
               for H, P in ((24, 64), (128, 64), (8, 32), (4, 8), (2, 128))
               for N in ssd_ops.SUPPORTED_N]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_P_and_fits_shared_memory(dtype):
    """Every plan's P-slices cover P exactly (pb >= 8 divides P), its
    blocks have at most 256 threads on the recurrence and 256 or 512 on
    the chunk path (whole 16-row chunk tiles, q <= 64) and its dynamic
    shared memory (the kernels declare
    no static shared memory; the `gpu` tests hold both against the
    compiled kernels) fits the H100's 227 KB. The path is the recurrence
    exactly up to rec_max_l(N) tokens, and the plan is the same whatever
    the number of groups."""
    for b, L, H, P, N in PLAN_SHAPES:
        p = ssd_ops.plan(b, L, H, P, 1, N, dtype)
        case = (b, L, H, P, N, p)
        assert p.pb >= 8 and P % p.pb == 0, case
        assert p.threads <= 512 and p.smem <= SMEM_LIMIT, case
        assert p.path == ("rec" if L <= ssd_ops.rec_max_l(N) else "chunk"), case
        if p.path == "chunk":
            assert p.q % 16 == 0 and 16 <= p.q <= 64
            assert p.threads in (256, 512)
            assert p.pb <= ssd_ops.slice_max(P, N), case
        else:
            assert p.threads == p.pb * N // ssd_ops.REC_COLUMNS
        assert ssd_ops.plan(b, L, H, P, 2, N, dtype) == p


def _blocks_per_sm(p):
    """Chunk-path blocks of plan p one SM holds at once."""
    return (1 if p.threads == ssd_ops.CHUNK_THREADS_ONE
            else ssd_ops.chunk_blocks_per_sm(p.smem))


@pytest.mark.parametrize("b,L,H,N,q,pb,threads", [
    (1, 512, 24, 128, 64, 16, 512), (1, 128, 24, 128, 64, 16, 512),
    (1, 512, 128, 16, 64, 64, 512), (2, 77, 24, 128, 32, 16, 256),
    (4, 1000, 24, 128, 32, 16, 256)])
def test_plan_chunk_runs_in_one_wave(b, L, H, N, q, pb, threads):
    """The chunk path at the served prefill shapes (mamba2-130m: 24 heads,
    N 128; jamba: 128 heads, N 16; G = 4 at b 2) takes the longest chunk
    and the narrowest slice whose blocks all run at once on the H100's
    132 SMs, one an SM with 16 warps where that fits, else two with 8;
    where neither does (4 long prefills), 32 tokens and the widest
    slice."""
    p = ssd_ops.plan(b, L, H, 64, 1, N, torch.float32)
    assert (p.path, p.q, p.pb, p.threads) == ("chunk", q, pb, threads)
    waves = (64 // p.pb) * H * b / (ssd_ops.N_SM * _blocks_per_sm(p))
    assert waves <= 1 or (b, L) == (4, 1000)


# ------------------------------------------------------------- the mixer

def _mixer_params(cfg, seed):
    """JAX mixer parameters with the deterministic leaves perturbed so
    that every one of them matters (numpy leaves)."""
    p = jax.tree.map(np.asarray, JS.ssm_params(jax.random.PRNGKey(seed),
                                               cfg))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "D_skip", "norm_scale", "dt_bias", "A_log"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)
                ).astype(np.float32)
    return p


def _state(cfg, rows, seed):
    """A random carried SSM state (numpy): f32 state and conv, pos."""
    z = jax.tree.map(np.asarray, JS.make_ssm_state(rows, cfg))
    rng = np.random.default_rng(seed)
    return {"ssm": (0.3 * rng.standard_normal(z["ssm"].shape)
                    ).astype(np.float32),
            "conv": rng.standard_normal(z["conv"].shape).astype(np.float32),
            "pos": rng.integers(0, 9, z["pos"].shape).astype(np.int32)}


MIXER_CASES = ["no_state", "batch_state", "slot_pool", "token_mask",
               "no_write"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MIXER_CASES)
def test_ssm_mixer_matches_jax(case, dtype):
    cfg = tiny_model_cfg("ssm")
    tcfg = _tcfg(cfg)
    p = _mixer_params(cfg, 3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    B, L = 3, 11
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kw_j, kw_t = {}, {}
    pool = rows = None
    if case != "no_state":
        pool = _state(cfg, 5, 6)
        rows = [3, 1, 4]
        if case == "batch_state":
            pool = {f: v[rows] for f, v in pool.items()}
            rows = [0, 1, 2]
        else:
            sidx = np.array(rows, np.int32)
            kw_j["slot_idx"] = jnp.asarray(sidx)
            kw_t["slot_idx"] = torch.from_numpy(sidx)
        kw_j["state"] = {f: jnp.asarray(v) for f, v in pool.items()}
        kw_t["state"] = {f: torch.from_numpy(v.copy()) for f, v in
                         pool.items()}
    if case == "token_mask":
        mask = np.zeros((B, L), bool)
        for b, n in enumerate((11, 6, 2)):     # real tokens are a prefix
            mask[b, :n] = True
        kw_j["token_mask"] = jnp.asarray(mask)
        kw_t["token_mask"] = torch.from_numpy(mask)
    if case == "no_write":
        kw_j["write"] = kw_t["write"] = False
    jo, jst = JS.ssm_mixer(jp, cfg, jx, **kw_j)
    to, tst = TS.ssm_mixer(tp, tcfg, tx, **kw_t)
    # JAX promotes the bf16 x f32 in_proj product to f32, and the mixer
    # stays f32 from there on: the output is f32 in both packages
    assert str(to.dtype).split(".")[-1] == str(jo.dtype)
    _close(to, jo)
    if case == "no_state":
        assert jst is None and tst is None
        return
    if case == "no_write":
        assert jst is None and tst is None
        for f, v in pool.items():                # the pool is untouched
            assert np.array_equal(kw_t["state"][f].numpy(), v)
        return
    # the port wrote the rows in place; the reference returns them
    assert tst is kw_t["state"]
    for f in ("ssm", "conv", "pos"):
        got = tst[f][torch.tensor(rows)]
        assert got.dtype == (torch.int32 if f == "pos" else torch.float32)
        if f == "pos":
            assert np.array_equal(got.numpy(), np.asarray(jst[f]))
        else:
            _close(got, jst[f])
    if case != "batch_state":                    # other slots untouched
        for f, v in pool.items():
            keep = [r for r in range(5) if r not in rows]
            assert np.array_equal(tst[f][keep].numpy(), v[keep])


# ------------------------------------------------------------- the models

@pytest.fixture(scope="module", params=["ssm", "hybrid"])
def pair(request):
    cfg = tiny_model_cfg(request.param)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    rng = np.random.default_rng(7)
    for stage in tree["stages"]:
        for sub in stage:
            for k in ("conv_b", "D_skip", "norm_scale", "dt_bias"):
                if k in sub["mixer"]:
                    sub["mixer"][k] = (sub["mixer"][k] + 0.3 *
                                       rng.standard_normal(
                                           sub["mixer"][k].shape)
                                       ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, _tcfg(cfg), "cpu")
    return cfg, _tcfg(cfg), jparams, tparams


def cache_from_numpy(tree, cfg):
    """The reference's stacked cache (numpy leaves) as the port's
    per-layer cache."""
    layers = []
    for (pattern, reps), stage in zip(TM.layer_plan(cfg), tree["stages"]):
        for r in range(reps):
            for j in range(len(pattern)):
                layers.append({key: {f: torch.tensor(np.array(a[r]))
                                     for f, a in sub.items()}
                               for key, sub in stage[j].items()})
    return {"layers": layers, "lengths": torch.tensor(tree["lengths"])}


EXACT = ("slot_pos", "pos")


def caches_close(tcache, jcache, cfg, rows=None):
    """Every layer's leaves (KV rows and SSM state within TOL, positions
    equal), restricted to `rows`, and the lengths."""
    jc = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg)
    sel = slice(None) if rows is None else torch.tensor(rows)
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        assert set(tl["self"]) == set(jl["self"])
        for f, v in tl["self"].items():
            if f in EXACT:
                assert torch.equal(v[sel], jl["self"][f][sel])
            else:
                _close(v[sel], jl["self"][f][sel])
    assert torch.equal(tcache["lengths"][sel], jc["lengths"][sel])


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_apply_logits(pair):
    cfg, tcfg, jp, tp = pair
    toks = _tokens(0, (2, 21), cfg.vocab)      # two chunks and a ragged one
    lj, _, _ = JM.apply(jp, cfg, jnp.asarray(toks))
    lt, _, _ = TM.apply(tp, tcfg, torch.tensor(toks))
    _close(lt, lj)


def test_prefill_decode_verify_extend(pair):
    """The plain-batch steps in sequence (chain verification without
    commit), logits and caches each time."""
    cfg, tcfg, jp, tp = pair
    B = 2
    jc = JM.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    toks = _tokens(1, (B, 19), cfg.vocab)
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = TM.prefill(tp, tcfg, torch.tensor(toks), tc)
    _close(lt, lj)
    caches_close(tc, jc, tcfg)

    nt = _tokens(2, (B, 1), cfg.vocab)
    lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(nt), jc)
    lt, tc, _ = TM.decode_step(tp, tcfg, torch.tensor(nt), tc)
    _close(lt, lj)
    caches_close(tc, jc, tcfg)

    vt = _tokens(3, (B, 5), cfg.vocab)
    lj, _, _ = JM.verify_chunk(jp, cfg, jnp.asarray(vt), jc)
    lt, _, _ = TM.verify_chunk(tp, tcfg, torch.tensor(vt), tc)
    _close(lt, lj)
    caches_close(tc, jc, tcfg)          # no-commit scoring writes nothing

    et = _tokens(4, (B, 3), cfg.vocab)
    lj, jc, _ = JM.extend(jp, cfg, jnp.asarray(et), jc)
    lt, tc, _ = TM.extend(tp, tcfg, torch.tensor(et), tc)
    _close(lt, lj)
    caches_close(tc, jc, tcfg)


def test_slot_steps(pair):
    """slot_extend (prefill with a token_mask suffix), slot_decode_step,
    slot_verify_chunk (chain) and a commit on a resident pool with
    padding rows on the scratch slot 0; real rows and slots compared."""
    cfg, tcfg, jp, tp = pair
    pool = 5
    jc = JM.init_cache(cfg, pool, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, pool, MAX_LEN, dtype=torch.float32, device="cpu")
    sidx = np.array([3, 1, 0, 0], np.int32)        # rows 2, 3: padding
    real, real_slots = [0, 1], [3, 1]
    js, ts = jnp.asarray(sidx), torch.tensor(sidx)

    toks = _tokens(5, (4, 16), cfg.vocab)
    tmask = np.zeros((4, 16), bool)
    tmask[0, :16] = True
    tmask[1, :9] = True                            # masked suffix of 7
    lj, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc, js,
                               token_mask=jnp.asarray(tmask))
    lt, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(toks), tc, ts,
                               token_mask=torch.tensor(tmask))
    _close(lt[real], np.asarray(lj)[real])
    caches_close(tc, jc, tcfg, rows=real_slots)

    nt = _tokens(6, (4, 1), cfg.vocab)
    lj, jc, _ = JM.slot_decode_step(jp, cfg, jnp.asarray(nt), jc, js)
    lt, tc, _ = TM.slot_decode_step(tp, tcfg, torch.tensor(nt), tc, ts)
    _close(lt[real], np.asarray(lj)[real])
    caches_close(tc, jc, tcfg, rows=real_slots)

    G = 5
    depth = np.broadcast_to(np.arange(G, dtype=np.int32), (4, G))
    mask = np.broadcast_to(np.tril(np.ones((G, G), bool)), (4, G, G))
    vt = _tokens(7, (4, G), cfg.vocab)
    lj = JM.slot_verify_chunk(jp, cfg, jnp.asarray(vt), jc, js,
                              jnp.asarray(depth), jnp.asarray(mask))
    lt = TM.slot_verify_chunk(tp, tcfg, torch.tensor(vt), tc, ts,
                              torch.tensor(depth.copy()),
                              torch.tensor(mask.copy()))
    _close(lt[real], np.asarray(lj)[real])
    caches_close(tc, jc, tcfg, rows=real_slots)

    ct = _tokens(9, (4, 3), cfg.vocab)
    lj, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(ct), jc, js)
    lt, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(ct), tc, ts)
    _close(lt[real], np.asarray(lj)[real])
    caches_close(tc, jc, tcfg, rows=real_slots)


def test_verification_writes_no_ssm_state(pair):
    """A verification forward (write=False) on a slot pool, with padding
    rows on the scratch slot, leaves every SSM leaf of every slot bitwise
    as it was: the scan is handed no state to write."""
    cfg, tcfg, jp, tp = pair
    tc = TM.init_cache(tcfg, 5, MAX_LEN, dtype=torch.float32, device="cpu")
    ts = torch.tensor([3, 1, 0, 0], dtype=torch.int32)
    TM.slot_extend(tp, tcfg, torch.tensor(_tokens(5, (4, 7), cfg.vocab)),
                   tc, ts)
    before = [{f: t.clone() for f, t in layer["self"].items()}
              for layer in tc["layers"] if "ssm" in layer["self"]]
    assert before
    G = 4
    depth = torch.arange(G, dtype=torch.int32).repeat(4, 1)
    mask = torch.tril(torch.ones((G, G), dtype=torch.bool)).repeat(4, 1, 1)
    TM.slot_verify_chunk(tp, tcfg, torch.tensor(_tokens(6, (4, G),
                                                        cfg.vocab)),
                         tc, ts, depth, mask)
    after = [layer["self"] for layer in tc["layers"] if "ssm" in
             layer["self"]]
    for b, a in zip(before, after):
        for f in b:
            assert torch.equal(a[f], b[f]), f


def test_params_from_numpy(pair):
    """The bridge carries every SSM leaf (in_proj, conv_w, conv_b, A_log,
    D_skip, dt_bias, norm_scale, out_proj) of every layer, across the
    hybrid plan's mixed stage patterns, bit for bit."""
    cfg, tcfg, jp, tp = pair
    tree = jax.tree.map(np.asarray, jp)
    specs = TM.layer_specs(tcfg)
    i = 0
    for (pattern, reps), stage in zip(TM.layer_plan(tcfg), tree["stages"]):
        for r in range(reps):
            for j in range(len(pattern)):
                layer = tp["layers"][i]
                want = stage[j]
                assert set(layer) == set(want)
                if specs[i].mixer == "ssm":
                    assert set(layer["mixer"]) == {
                        "in_proj", "conv_w", "conv_b", "A_log", "D_skip",
                        "dt_bias", "norm_scale", "out_proj"}
                for key, sub in want.items():
                    for f, a in sub.items():
                        assert np.array_equal(layer[key][f].numpy(), a[r])
                i += 1
    assert i == cfg.n_layers
    kinds = [s.mixer for s in specs]
    assert kinds == (["ssm", "ssm"] if cfg.family == "ssm"
                     else ["ssm", "attn"])
