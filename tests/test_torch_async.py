"""The port's wall-clock backend (`AsyncTorchBackend` driven by
`WallClockExecutor`) on the CPU, against the JAX package.

Both engines get the same numpy-bridged tiny float32 weights, the same
seed and the same prompts. The port's async backend runs its two threads
(verification server and engine) with `device="cpu"`, so it is held here
on what the CPU can show:

  * its committed streams equal the port's own greedy decode and the JAX
    engine's, for every speculative strategy on the `attn` family and
    for `cosine` on an `ssm` chain;
  * they stay exact under admission churn, staggered arrivals with more
    requests than slots, and preemption with re-admission, and on the
    paged pool and with an int8 drafter;
  * `on_commit` sees every token once, in nondecreasing wall time, with
    `req.done` set at the last commit;
  * drafting overlaps an in-flight verification with `overlap=True` and
    never with `overlap=False` — shown by a verification that waits on a
    `threading.Event`, not by wall time;
  * a task that raises on the server thread surfaces from `run()`;
  * `make_backend` resolves the specs and `shutdown` joins the server.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig
from repro.models import model as JM
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.backend import (AsyncTorchBackend, SimulatedBackend,
                                         make_backend)
from repro_torch.serving.engine import SpeculativeEngine

MAX_LEN = 96
NEW = 10


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def models():
    """{family: (jax side, torch side)}; each side is (target, drafters):
    a random dense drafter and a perfect one sharing the target's
    weights, so speculation is accepted and draft-ahead survives."""
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=50, tie_embeddings=True,
                       dtype="float32")
    dp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), dcfg))
    tdp = params_from_numpy(dp, _tcfg(dcfg), "cpu")
    out = {}
    for family in ("attn", "ssm"):
        cfg = tiny_model_cfg(family)
        tp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                     cfg))
        ttp = params_from_numpy(tp, _tcfg(cfg), "cpu")
        out[family] = (((cfg, tp), [(dcfg, dp, "d0"), (cfg, tp, "d1")]),
                       ((_tcfg(cfg), ttp), [(_tcfg(dcfg), tdp, "d0"),
                                            (_tcfg(cfg), ttp, "d1")]))
    return out


def _prompts(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 50, int(k)).tolist()
            for k in rng.integers(4, 14, n)]


def _cos(**kw):
    base = dict(n_drafters=2, draft_len=4, drafters_per_request=2,
                tree_width=2)
    base.update(kw)
    return CoSineConfig(**base)


def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    last = lg[0, -1, : cfg.vocab]
    out = []
    for _ in range(n):
        t = int(torch.argmax(last))
        out.append(t)
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[t]]), cache)
        last = lg[0, 0, : cfg.vocab]
    return out


def _async_engine(side, strategy="cosine", cos=None):
    target, drafters = side
    return SpeculativeEngine(target, drafters, _tcfg(cos or _cos()),
                             strategy=strategy, max_len=MAX_LEN, seed=0,
                             backend="async", device="cpu")


def _serve(eng, prompts, arrivals=None, **submit_kw):
    arrivals = arrivals or [0.0] * len(prompts)
    reqs = [eng.submit(p, max_new_tokens=NEW, arrival_ms=t, **submit_kw)
            for p, t in zip(prompts, arrivals)]
    try:
        stats = eng.run()
    finally:
        eng.backend.shutdown()
    return reqs, stats


@pytest.mark.parametrize("family,strategy", [
    ("attn", "cosine"), ("attn", "pipeinfer"), ("attn", "vanilla"),
    ("attn", "specinfer"), ("ssm", "cosine")])
def test_async_streams_equal_greedy_and_jax(models, family, strategy):
    jax_side, torch_side = models[family]
    prompts = _prompts(3)
    eng = _async_engine(torch_side, strategy)
    assert isinstance(eng.backend, AsyncTorchBackend)
    assert eng.backend.target_stream is None       # the CPU: no streams
    reqs, stats = _serve(eng, prompts)
    streams = [list(map(int, r.generated)) for r in reqs]
    (tcfg, tparams), _ = torch_side
    for s, p in zip(streams, prompts):
        assert s == _greedy(tcfg, tparams, p, NEW)
    jeng = JaxEngine(jax_side[0], jax_side[1], _cos(), strategy=strategy,
                     max_len=MAX_LEN, seed=0)
    jreqs = [jeng.submit(p, max_new_tokens=NEW) for p in prompts]
    jeng.run()
    assert streams == [list(map(int, r.generated)) for r in jreqs]
    # wall-clock records are measured, not booked
    assert all(r.done for r in reqs)
    assert stats.records and all(r.verify_ms > 0 for r in stats.records)
    assert all(r.t_iter_ms >= 0 for r in stats.records)
    assert stats.total_committed == len(prompts) * NEW


@pytest.mark.parametrize("variant", ["paged pool", "int8 drafter"])
def test_async_paged_pool_and_int8_drafter_are_greedy_exact(models, variant):
    """The wall-clock backend over the paged KV pool (small pools that
    must grow) and with an int8 drafter: the CPU shows the streams stay
    greedy-exact (the card's runs of these are ROADMAP work)."""
    from repro_torch.configs.drafters import int8_variant

    _, (target, drafters) = models["attn"]
    if variant == "paged pool":
        cos = _cos(paged_pool=True, page_size=16, pool_pages=4)
    else:
        cos = _cos()
        (dcfg, dp, name), perfect = drafters
        drafters = [(int8_variant(dcfg), dp, name), perfect]
    eng = _async_engine((target, drafters), cos=cos)
    prompts = _prompts(3)
    reqs, _ = _serve(eng, prompts)
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(*target, p, NEW)
    if variant == "paged pool":
        assert eng.target.slots.n_page_growths > 0
    else:
        assert eng.drafters[0].cfg.quant == "int8"


def test_async_lossless_under_churn(models):
    """Admission churn (tight batch, priorities, preemption and shed
    pressure) on the wall-clock loop: every request that completes is
    still greedy-exact."""
    _, side = models["attn"]
    cos = _cos(enable_admission=True, max_batch=2, admit_queue_cap=2,
               preempt_priority=True, default_slo_ms=1e6)
    eng = _async_engine(side, cos=cos)
    prompts = _prompts(5, seed=9)
    reqs = [eng.submit(p, max_new_tokens=8, arrival_ms=0.0, priority=i % 3)
            for i, p in enumerate(prompts)]
    try:
        stats = eng.run()
    finally:
        eng.backend.shutdown()
    done = [(r, p) for r, p in zip(reqs, prompts) if r.done]
    assert done, "churn shed everything: config too tight"
    (cfg, params), _ = side
    for r, p in done:
        assert list(map(int, r.generated)) == _greedy(cfg, params, p, 8)
    assert stats.total_committed >= sum(len(r.generated) for r, _ in done)


def test_async_staggered_arrivals_beyond_the_slot_pool(models):
    """Ten requests at once, then two more 20 and 40 wall ms later,
    through runners of eight slots: the pools grow, late arrivals are
    served beside (or after) the first ones, and every stream is
    greedy-exact."""
    _, side = models["attn"]
    eng = _async_engine(side)
    prompts = _prompts(12, seed=21)
    arrivals = [0.0] * 10 + [20.0, 40.0]
    reqs, stats = _serve(eng, prompts, arrivals)
    (cfg, params), _ = side
    for r, p in zip(reqs, prompts):
        assert r.done and r.finish_ms >= r.arrival_ms
        assert list(map(int, r.generated)) == _greedy(cfg, params, p, NEW)
    assert stats.total_committed == 12 * NEW
    assert eng.target.slots.n_slots > 8
    assert all(d.slots.n_slots > 8 for d in eng.drafters)


def test_async_on_commit_streams_every_token_once(models):
    """Commits arrive in nondecreasing wall time, the hook sees every
    committed token once as it commits, and the final commit observes
    req.done already set (a streaming consumer keyed on it terminates)."""
    _, side = models["attn"]
    eng = _async_engine(side)
    seen, times, done_at = {}, [], {}

    def on_commit(req, toks, now_ms):
        seen.setdefault(req.rid, []).extend(toks)
        times.append(now_ms)
        done_at[req.rid] = req.done

    eng.on_commit = on_commit
    reqs, _ = _serve(eng, _prompts(3))
    assert times == sorted(times) and len(times) > len(reqs)
    for r in reqs:
        assert seen[r.rid] == list(r.generated)
        assert done_at[r.rid] is True


def _hold_verifications(eng):
    """Make every verification forward wait in flight until the engine
    thread is about to read its result (it has drafted ahead by then, if
    it drafts ahead at all). Returns the list that gets, for each drafter
    decode, whether a verification was in flight while it ran."""
    backend, ex = eng.backend, eng.executor
    in_flight = threading.Event()
    release = threading.Event()
    during = []
    verify = backend.target.verify_device
    draft_decode = backend.draft_decode
    resolve = ex._resolve_prefills

    def held_verify(*a, **kw):
        in_flight.set()
        assert release.wait(timeout=30), "the engine never read the result"
        try:
            return verify(*a, **kw)
        finally:
            in_flight.clear()
            release.clear()

    def counted_decode(*a, **kw):
        during.append(in_flight.is_set())
        return draft_decode(*a, **kw)

    def resolve_then_release(entries):
        # the engine thread is done drafting ahead: the walk comes next
        release.set()
        return resolve(entries)

    backend.target.verify_device = held_verify
    backend.draft_decode = counted_decode
    ex._resolve_prefills = resolve_then_release
    return during


@pytest.mark.parametrize("overlap", [True, False])
def test_async_drafts_ahead_only_with_overlap(models, overlap):
    """Deterministic overlap: with `overlap=True` the next cohort is
    drafted while the current verification is held in flight, and most
    cohorts began drafting before the previous verification ended; with
    `overlap=False` (the serial twin) no drafter step ever runs while a
    verification is in flight."""
    _, side = models["attn"]
    eng = _async_engine(side)
    eng.executor.overlap = overlap
    during = _hold_verifications(eng)
    prompts = _prompts(3)
    reqs, stats = _serve(eng, prompts)
    (cfg, params), _ = side
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(cfg, params, p, NEW)
    rs = stats.records
    began_early = sum(1 for prev, nxt in zip(rs, rs[1:])
                      if nxt.draft_start_ms
                      < prev.verify_start_ms + prev.verify_ms)
    assert during and len(rs) > 2
    if overlap:
        assert any(during) and began_early / (len(rs) - 1) >= 0.5
    else:
        assert not any(during) and began_early == 0


def test_async_preemption_readmit_lossless(models):
    """Priority preemption and re-admission on the wall-clock loop: a
    low-priority request is served alone until two urgent ones arrive
    (submitted from its first commit); with verifications held in flight
    the server is saturated, so the second urgent arrival evicts it
    (batch of one), and it comes back through the async burst-prefill
    queue with prompt + generated. Every stream stays exact."""
    _, side = models["attn"]
    cos = _cos(enable_admission=True, max_batch=1, preempt_priority=True,
               default_slo_ms=1e6)
    eng = _async_engine(side, cos=cos)
    _hold_verifications(eng)
    prompts = _prompts(3, seed=11)
    lengths = [24, NEW, NEW]
    reqs = [eng.submit(prompts[0], max_new_tokens=lengths[0], priority=2)]

    def arrive(req, toks, now_ms):
        if len(reqs) == 1:
            reqs.extend(eng.submit(p, max_new_tokens=n, arrival_ms=now_ms,
                                   priority=0)
                        for p, n in zip(prompts[1:], lengths[1:]))

    eng.on_commit = arrive
    try:
        stats = eng.run()
    finally:
        eng.backend.shutdown()
    assert stats.n_preempted > 0 and reqs[0].n_preemptions == 1
    (cfg, params), _ = side
    for r, p, n in zip(reqs, prompts, lengths):
        assert r.done
        assert list(map(int, r.generated)) == _greedy(cfg, params, p, n)


def test_async_server_exception_surfaces_from_run(models):
    _, side = models["attn"]
    eng = _async_engine(side)

    def broken(*a, **kw):
        raise RuntimeError("verification server fault")

    eng.backend.target.verify_device = broken
    eng.submit(_prompts(1)[0], max_new_tokens=NEW)
    try:
        with pytest.raises(RuntimeError, match="verification server fault"):
            eng.run()
    finally:
        eng.backend.shutdown()


def test_make_backend_resolution_and_shutdown(models):
    _, ((tcfg, tp), ds) = models["attn"]
    assert isinstance(make_backend(None, (tcfg, tp), ds, MAX_LEN,
                                   device="cpu"), SimulatedBackend)
    assert isinstance(make_backend("sim", (tcfg, tp), ds, MAX_LEN,
                                   device="cpu"), SimulatedBackend)
    b = make_backend("async", (tcfg, tp), ds, MAX_LEN, device="cpu")
    assert isinstance(b, AsyncTorchBackend) and b.is_wallclock
    assert make_backend(b, (tcfg, tp), ds, MAX_LEN) is b
    with pytest.raises(ValueError):
        make_backend("gpu", (tcfg, tp), ds, MAX_LEN, device="cpu")
    fut, span = b.submit_target("probe", lambda: threading.current_thread())
    worker = fut.result(timeout=30)
    assert worker is not threading.current_thread()
    assert worker.name.startswith("verify-server")
    assert b.drain_timeline() == [span] and span["t1"] >= span["t0"]
    b.shutdown()
    assert not worker.is_alive()
    with pytest.raises(RuntimeError):
        b.submit_target("late", lambda: None)
    # the wall-clock backend serves speculative strategies only
    with pytest.raises(AssertionError, match="ar baseline"):
        SpeculativeEngine((tcfg, tp), ds, _tcfg(_cos()), strategy="ar",
                          max_len=MAX_LEN, backend="async", device="cpu")
