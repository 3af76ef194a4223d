"""The SSD scan's gradient in the PyTorch port against the JAX package
(CPU, float32 arithmetic).

* The same numpy inputs go through four routes: `jax.grad` of the
  reference's `repro.models.ssm.ssd_chunked`, autograd through the
  port's `ssd_chunked`, the port's adjoint `ssd_grad`, and
  `SSDScanFunction` (`scan`) on CPU tensors. The loss is
  sum(y * dy) + sum(final_state * dfinal) for fixed random dy and
  dfinal, so every input and the initial state receive a gradient. Each
  gradient leaf is within 2e-4 of its largest value (the SSD tests'
  tolerance: f32 sums in other orders). Where x, B and C are bf16, the
  reference's gradient is taken at f32 inputs that hold the same bf16
  values (its y's rounding to bf16 does not reach the gradient): JAX
  given bf16 x converts it to f32 twice and rounds each conversion's
  cotangent to bf16 before adding them, so its own bf16 gradient is off
  by more than the summation order. The port rounds each of those three
  gradients to bf16 once, so they may also differ by one bf16 step of
  the element.
* The training forward takes `scan` and nothing else: `ssd` and
  `ssd_slots` with state=None under grad mode, not under `no_grad`, and
  the reduced mamba2-130m and jamba-v0.1-52b of
  `tests/test_torch_train.py` (whose losses and gradients that file holds
  to the reference) reach `ssd_grad` once for each SSM layer; their
  gradient leaves equal those of autograd through the plain scan within
  1e-5 of each leaf's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.configs import ARCHS
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.optim.optimizers import tree_leaves

SSD_TOL = 2e-4
NAMES = ("x", "dt", "A", "B", "C", "init")

# (b, L, H, P, G, N, chunk, masked tail, x/B/C dtype, initial state)
CASES = {
    # G < H, L not a multiple of the chunk, an initial state
    "groups_ragged": (2, 37, 4, 8, 2, 8, 16, 0, "float32", True),
    # a masked suffix (dt = 0), one head a group
    "masked_tail": (1, 40, 3, 16, 3, 16, 16, 7, "float32", True),
    # x, B and C in bf16
    "bf16": (2, 33, 4, 8, 1, 16, 16, 0, "bfloat16", True),
    # no initial state, L shorter than the chunk (one chunk of L)
    "one_chunk": (2, 12, 2, 8, 1, 32, 64, 0, "float32", False),
}


def _inputs(case, seed=0):
    b, L, H, P, G, N, _, tail, _, init = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)) - 1.0)).astype(
        np.float32)
    if tail:
        dt[:, -tail:] = 0.0
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    B = rng.standard_normal((b, L, G, N)).astype(np.float32)
    C = rng.standard_normal((b, L, G, N)).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, H, P, N))).astype(np.float32)
    dy = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dfinal = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return [x, dt, A, B, C, s0 if init else None], dy, dfinal


def _bf16_round(a):
    """numpy f32 values rounded to bf16 (so both frameworks start from
    the same bits)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# XLA's CPU backend spends most of a gradient's seconds optimizing the
# compiled program; without those passes it computes the same f32
# function (`tests/test_torch_train.py::_FAST_COMPILE`)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _jax_grads(ins, dy, dfinal, chunk):
    """f32 gradients of the reference's scan at `ins` (f32)."""
    args = [jnp.asarray(a) for a in ins if a is not None]
    init = ins[5] is not None

    def loss(*a):
        y, final = JS.ssd_chunked(*a[:5], chunk, a[5] if init else None)
        return jnp.sum(y * dy) + jnp.sum(final * dfinal)

    fn = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))
    grads = fn.lower(*args).compile(compiler_options=_FAST_COMPILE)(*args)
    return [np.asarray(g, np.float32) for g in grads]


def _torch_inputs(ins, low, grad=False):
    dtype = torch.bfloat16 if low else torch.float32
    out = []
    for i, a in enumerate(ins):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(a).to(dtype if i in (0, 3, 4)
                                   else torch.float32)
        out.append(t.requires_grad_() if grad else t)
    return out


def _routes(case, ins, dy, dfinal):
    """{route: [gradient of each input that is given]} of the port."""
    chunk, low = case[6], case[8] == "bfloat16"
    dy_t, df_t = torch.from_numpy(dy), torch.from_numpy(dfinal)
    out = {}
    for route in ("autograd", "function"):
        t = _torch_inputs(ins, low, grad=True)
        fn = ssd_ops.ssd_chunked if route == "autograd" else ssd_ops.scan
        y, final = fn(*t[:5], chunk, t[5])
        loss = (y.float() * dy_t).sum() + (final * df_t).sum()
        given = [a for a in t if a is not None]
        out[route] = list(torch.autograd.grad(loss, given))
        assert all(g.dtype == a.dtype for g, a in zip(out[route], given))
    t = _torch_inputs(ins, low)
    grads = ssd_ops.ssd_grad(*t[:5], chunk, t[5], dy_t.to(t[0].dtype),
                             df_t)
    out["ssd_grad"] = [g for g in grads if g is not None]
    return out


def _close(got, want, name, low):
    got = got.detach().float().numpy()
    scale = max(float(np.abs(want).max()), 1e-12)
    err = np.abs(got - want)
    if low and name in ("x", "B", "C"):
        # one bf16 step (8 significant bits) of the element on top
        err = err - np.abs(want) * 2.0 ** -7
    assert float(err.max()) <= SSD_TOL * scale, (name, float(err.max()),
                                                 scale)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CASES))
def test_ssd_gradients_match_jax(name):
    case = CASES[name]
    low = case[8] == "bfloat16"
    ins, dy, dfinal = _inputs(case)
    if low:
        ins = [_bf16_round(a) if i in (0, 3, 4) else a
               for i, a in enumerate(ins)]
        dy = _bf16_round(dy)
    want = _jax_grads(ins, dy, dfinal, case[6])
    names = [n for n, a in zip(NAMES, ins) if a is not None]
    assert len(want) == len(names)
    for route, grads in _routes(case, ins, dy, dfinal).items():
        assert len(grads) == len(names), route
        for g, w, n in zip(grads, want, names):
            assert tuple(g.shape) == w.shape, (route, n)
            _close(g, w, n, low)


def test_gradient_calls_take_scan_and_others_do_not(monkeypatch):
    """`ssd` and `ssd_slots` (state=None) go through `SSDScanFunction`
    when an input requires a gradient under grad mode, and not under
    `no_grad`, with inputs that ask for none, or with a carried state."""
    calls = []
    apply = ssd_ops.SSDScanFunction.apply
    monkeypatch.setattr(ssd_ops.SSDScanFunction, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    case = CASES["groups_ragged"]
    ins, _, _ = _inputs(case)
    x, dt, A, B, C, s0 = _torch_inputs(ins, False)
    xg = x.clone().requires_grad_()
    y, final = ssd_ops.ssd(xg, dt, A, B, C, 16, s0)
    assert len(calls) == 1 and y.requires_grad and final.requires_grad
    y2 = ssd_ops.ssd_slots(xg, dt, A, B, C, 16, None)
    assert len(calls) == 2 and y2.requires_grad
    torch.testing.assert_close(y2, ssd_ops.ssd(x, dt, A, B, C, 16)[0],
                               rtol=0, atol=0)
    with torch.no_grad():
        ssd_ops.ssd(xg, dt, A, B, C, 16, s0)
        ssd_ops.ssd_slots(xg, dt, A, B, C, 16, None)
    ssd_ops.ssd(x, dt, A, B, C, 16, s0)
    ssd_ops.ssd_slots(xg, dt, A, B, C, 16, s0.clone(), write=False)
    assert len(calls) == 2


def _model(name):
    base = ARCHS[name].reduced().with_overrides(dtype="float32")
    if name == "mamba2-130m":
        return base.with_overrides(n_layers=1)
    cfg = base.with_overrides(n_layers=2, hybrid_attn_offset=1)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                      layer_offset=0))


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-v0.1-52b"])
def test_model_gradients_go_through_ssd_grad(name, monkeypatch):
    """The reduced configs of `tests/test_torch_train.py`: one
    `ssd_grad` a step for each SSM layer, and every gradient leaf as
    autograd through the plain scan gives it."""
    cfg = _model(name)
    params = TM.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    calls = []
    grad = ssd_ops.ssd_grad
    monkeypatch.setattr(ssd_ops, "ssd_grad",
                        lambda *a: calls.append(1) or grad(*a))
    loss, _, grads = TT.value_and_grad(params, cfg, tokens, remat=False)
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    assert n_ssm >= 1 and len(calls) == n_ssm

    def plain(x, dt, A, B, C, chunk, state, slot_idx=None, write=True):
        assert state is None
        return ssd_ops.ssd_chunked(x, dt, A, B, C, chunk)[0]

    monkeypatch.setattr(ssd_ops, "ssd_slots", plain)
    loss_p, _, grads_p = TT.value_and_grad(params, cfg, tokens, remat=False)
    assert len(calls) == n_ssm
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-5 * scale
