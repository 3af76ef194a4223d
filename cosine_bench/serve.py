"""One cell on the program: set-up, the ramp, the measured window and,
with tracing, a profiled stretch at the window's end.

The entry the window drives is the program's `SpeculativeEngine` on its
wall-clock backend (`backend="async"`: the verification server thread
and the `WallClockExecutor`). The harness submits requests as its
clients send them, calls `step()` inside `backend.engine_stream()` until
the window closes, and stamps each delivered token with its own clock
(`time.perf_counter`) through `engine.on_commit`.

With tracing the harness wraps, from its own files, the program's calls
it attributes time to: the model-side attention calls that hand work to
the attention kernels (`models.attention.attend_partial`,
`cache_partial`, `blocked_attention`; the outermost call of a thread
only) and each MoE layer (`models.moe.apply_moe`) in `record_function`
ranges, with each attention call's work reckoned from its arguments
(`yardstick.attention_work`); the target's prefills (for the served
operations); and labelled host intervals around the engine's and the
server's calls into each layer (draft, verify dispatch, the waits, the
acceptance walk, the commits), which name the device's idle gaps.
Nothing of this runs outside the profiled stretch.
"""
from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from cosine_bench import traffic, weights, yardstick

ANCHOR = "cosine_bench: anchor"
ATTN_RANGE = "cosine_bench: attention"
MOE_RANGE = "cosine_bench: moe layer"

#: iterations the profiler records, at the end of the window: its trace
#: must be read well inside the run's time limit
PROFILE_ITERATIONS = 2
#: the profiled stretch never exceeds this many iterations
PROFILE_MAX_ITERATIONS = 3
#: how much slower an iteration runs under the profiler (an estimate;
#: measured 2-3x; used only to place the stretch's start)
PROFILE_SLOWDOWN = 2.0
#: seed role of the engine's own generator (the router's exploration)
ENGINE_ROLE = 99
#: iterations served after every client has its first token and before
#: the window opens
WARM_ITERATIONS = 1
#: seed stream of the draw of the verification rows the check compares
VERIFY_STREAM = 13


@dataclass
class Sent:
    """One request as its client sees it."""
    client: int
    spec: traffic.RequestSpec
    rid: int
    sent: float                  # perf_counter seconds
    stamps: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done: Optional[float] = None
    #: refused or lost by the program (never set by this program, which
    #: admits every request; counted as an infinite wait)
    failed: bool = False


def _model_config(d: dict):
    from repro_torch.config import ModelConfig, MoEConfig
    d = dict(d)
    moe = d.pop("moe", None)
    return ModelConfig(**d, moe=MoEConfig(**moe) if moe else None)


def build_weights(torch, conf: dict, seed: int, device):
    """The target's and each drafter's weights, made from `seed` on
    `device` (the program's parameter-tree layout)."""
    dr = conf["drafters"]
    return (weights.build(torch, conf, conf["reference"], seed,
                          weights.TARGET_ROLE, device),
            [weights.build(torch, dr["config"], dr["reference"], seed,
                           weights.drafter_role(i), device)
             for i in range(len(dr["domains"]))])


def build_engine(torch, conf: dict, seed: int, device, params=None):
    """The program's engine for configuration `conf`, with the weights
    `params` (`build_weights`; made from `seed` on `device` where not
    given)."""
    from repro_torch.config import CoSineConfig
    from repro_torch.serving.engine import SpeculativeEngine
    prog = conf["program"]
    tcfg = _model_config(prog["target"])
    dcfg = _model_config(prog["drafter"])
    tparams, dparams = params or build_weights(torch, conf, seed, device)
    drafters = [(dcfg, p, dom)
                for p, dom in zip(dparams, conf["drafters"]["domains"])]
    return SpeculativeEngine(
        (tcfg, tparams), drafters, CoSineConfig(**prog["cosine"]),
        strategy=prog["strategy"], max_len=prog["max_len"],
        seed=weights.model_seed(seed, ENGINE_ROLE),
        backend=prog["backend"], device=device)


class HostLog:
    """Labelled host intervals (thread, label, t0, t1; perf_counter
    seconds) of wrapped calls, recorded while `on` is set."""

    def __init__(self):
        self.spans = []
        self.on = False
        self._saved = []

    def wrap(self, owner, name, label):
        orig = getattr(owner, name)

        def timed(*a, **kw):
            if not self.on:
                return orig(*a, **kw)
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.spans.append((threading.current_thread().name, label,
                                   t0, time.perf_counter()))

        self._saved.append((owner, name, orig))
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []


class Tracing:
    """The profiled stretch's hooks (see the module docstring)."""

    def __init__(self, torch, eng, target_conf: dict, device):
        from repro_torch.core import tree as tree_mod
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import moe as moe_mod
        from repro_torch.serving import backend as backend_mod
        self.torch = torch
        self.device = device
        self.target_conf = target_conf
        self.log = HostLog()
        self.attn = []           # (t0, bytes, flops, peak) of each call
        self.prefills = []       # (t0, [context length, ...])
        self._tls = threading.local()
        self.prof = None
        self.t_anchor = None
        b = eng.backend
        for name in ("attend_partial", "cache_partial", "blocked_attention"):
            self._wrap_attention(attn_mod, name)
        self._wrap_range(moe_mod, "apply_moe", MOE_RANGE)
        self._wrap_prefill(b.target, "prefill_requests")
        self._wrap_prefill(b.target, "prefill_request")
        log = self.log
        log.wrap(eng, "_draft_entries", "engine: draft")
        log.wrap(b, "prefill_drafters", "engine: drafter prefill")
        log.wrap(eng, "_verify_dispatch", "engine: verify dispatch")
        log.wrap(eng.executor, "_resolve_prefills",
                 "engine: wait for target prefill")
        log.wrap(backend_mod.VerifyHandle, "result",
                 "engine: wait for verify logits")
        log.wrap(eng, "_resolve_tails", "engine: wait for commit tails")
        log.wrap(tree_mod, "accept_tree_greedy", "engine: acceptance walk")
        log.wrap(eng.router, "update", "engine: router update")
        log.wrap(b, "commit_target_async", "engine: commit dispatch")
        log.wrap(b, "commit_drafters", "engine: drafter commit")
        log.wrap(eng, "_finalize", "engine: finalize and client sends")
        log.wrap(b.target, "verify_device", "server: verify forward")
        log.wrap(b.target, "extend_committed", "server: commit forward")
        log.wrap(b.target, "prefill_requests", "server: target prefill")
        if torch.cuda.is_available():
            log.wrap(torch.cuda.Stream, "synchronize",
                     "server: wait for its stream")

    @property
    def on(self):
        return self.log.on

    def _outer(self):
        return getattr(self._tls, "depth", 0) == 0

    def _wrap_range(self, owner, name, range_name):
        from torch.profiler import record_function
        orig = getattr(owner, name)

        def ranged(*a, **kw):
            if not self.on:
                return orig(*a, **kw)
            with record_function(range_name):
                return orig(*a, **kw)

        self.log._saved.append((owner, name, orig))
        setattr(owner, name, ranged)

    def _wrap_attention(self, owner, name):
        from torch.profiler import record_function
        orig = getattr(owner, name)
        torch = self.torch

        def ranged(*a, **kw):
            if not self.on or not self._outer():
                return orig(*a, **kw)
            t = time.perf_counter()
            self._tls.depth = 1
            try:
                with record_function(ATTN_RANGE):
                    out = orig(*a, **kw)
            finally:
                self._tls.depth = 0
            self.attn.append((t, *_attention_work(torch, name, a, kw)))
            return out

        self.log._saved.append((owner, name, orig))
        setattr(owner, name, ranged)

    def _wrap_prefill(self, owner, name):
        orig = getattr(owner, name)

        def counted(*a, **kw):
            if not self.on or not self._outer():
                return orig(*a, **kw)
            if name == "prefill_requests":
                lens = [len(t) for t in a[0].values()]
            else:
                lens = [len(a[1])]
            self.prefills.append((time.perf_counter(), lens))
            self._tls.depth = 1
            try:
                return orig(*a, **kw)
            finally:
                self._tls.depth = 0

        self.log._saved.append((owner, name, orig))
        setattr(owner, name, counted)

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """Start and stop the profiler once around a trivial operation, so
        that its first start (CUPTI's initialisation, seconds) falls in
        set-up and not in the profiled stretch."""
        with self._profile():
            self.torch.ones(1, device=self.device).add_(1)
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def _profile(self):
        """A profiler over the host operations of every thread (the
        verification server's too), where this PyTorch offers it."""
        from torch.profiler import profile
        try:
            from torch._C._profiler import _ExperimentalConfig
            cfg = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            cfg = None
        return profile(activities=self._activities(), experimental_config=cfg)

    def start(self):
        from torch.profiler import record_function
        self.prof = self._profile()
        self.prof.start()
        with record_function(ANCHOR):
            self.t_anchor = time.perf_counter()
        self.log.on = True

    def stop(self):
        self.log.on = False
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.stop()
        self.log.restore()

    def reduce(self, t0: float, t1: float, sent: List[Sent]):
        """The profiled stretch [t0, t1] (perf_counter seconds) as the
        readers take it: device busy and idle, device time in the named
        ranges, the attention calls' bound, the served operations, the
        breakdown; only the stretch's length where the profiler recorded
        no device activity."""
        torch = self.torch
        events, read_s = yardstick.profiler_events(torch, self.prof)
        anchor = [e for e in events if e.name == ANCHOR]
        dev = yardstick.device_events(torch, events)
        out = dict(read_s=read_s, t0=t0, t1=t1, window_s=t1 - t0)
        if not anchor or not dev:
            return out
        off = anchor[0].time_range.start - self.t_anchor * 1e6
        w0, w1 = t0 * 1e6 + off, t1 * 1e6 + off
        ivals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in dev
                 if e.time_range.end > w0 and e.time_range.start < w1]
        merged = yardstick.merge(ivals)
        busy = sum(b - a for a, b in merged)
        out.update(busy_s=busy / 1e6)
        n_attn, attn_us = yardstick.range_device_us(torch, events,
                                                    ATTN_RANGE, w0, w1)
        n_moe, moe_us = yardstick.range_device_us(torch, events, MOE_RANGE,
                                                  w0, w1)
        calls = [c for c in self.attn if t0 <= c[0] < t1]
        if calls:
            work = torch.stack([torch.stack([b, f]) for _, b, f, _ in
                                calls]).cpu().tolist()
            bound = sum(yardstick.bound_s(b, f, c[3])
                        for (b, f), c in zip(work, calls))
            out.update(attn_calls=n_attn, attn_device_s=attn_us / 1e6,
                       attn_bound_s=bound)
        if n_moe:
            out.update(moe_calls=n_moe, moe_device_s=moe_us / 1e6)
        out["served_flops"] = _served_flops(self.target_conf, self.prefills,
                                            sent, t0, t1)
        out["breakdown"] = _breakdown(dev, merged, w0, w1, off,
                                      self.log.spans)
        return out


def _attention_work(torch, name, a, kw):
    """(bytes, flops, peak rate) of one model-side attention call, from
    its arguments (device scalars for bytes and flops)."""
    if name == "cache_partial":
        q, cache, q_pos = a[:3]
        k, v, kp = cache["k"], cache["v"], cache["slot_pos"]
        slot_idx, pv = kw.get("slot_idx"), kw.get("page_view")
        if pv is not None:
            kp = kp[pv.long()].reshape(pv.shape[0], -1)
            slot_idx = None
        b, f = yardstick.attention_work(
            torch, q, k, v, q_pos, kp, slot_idx=slot_idx,
            v_in_k=kw.get("v_in_k", False))
    else:
        q, k, v, q_pos, k_pos = a[:5]
        b, f = yardstick.attention_work(
            torch, q, k, v, q_pos, k_pos, slot_idx=kw.get("slot_idx"),
            mask=kw.get("extra_mask"), causal=kw.get("causal", True))
    kv = str(k.dtype).replace("torch.", "")
    return b, f, yardstick.attention_peak(kv)


def _served_flops(target, prefills, sent, t0, t1):
    """Target operations of the tokens served in [t0, t1]: the prompt
    tokens of every target prefill that began in it, and every output
    token delivered in it, each at its context length."""
    total = 0.0
    for t, lens in prefills:
        if t0 <= t <= t1:
            for n in lens:
                total += sum(yardstick.token_flops(target, c)
                             for c in range(1, n + 1))
    for s in sent:
        P = len(s.spec.prompt)
        for i, st in enumerate(s.stamps):
            if t0 <= st <= t1:
                total += yardstick.token_flops(target, P + i + 1)
    return total


def _breakdown(dev, merged, w0, w1, off, spans):
    """The device operations that took the most time, and the device's
    idle time in the stretch by what each host thread was doing (the
    labelled intervals overlapping the idle gaps; a thread's unlabelled
    remainder under "<thread>: other")."""
    by_name = {}
    for e in dev:
        if e.time_range.end > w0 and e.time_range.start < w1:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.end - e.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    us = [(th, lab, a * 1e6 + off, b * 1e6 + off) for th, lab, a, b in spans]
    threads = sorted({th for th, *_ in us})
    idle = {}
    for g0, g1 in gaps:
        for th in threads:
            labelled = 0.0
            for th2, lab, a, b in us:
                ov = min(b, g1) - max(a, g0)
                if th2 == th and ov > 0:
                    idle[lab] = idle.get(lab, 0.0) + ov
                    labelled += ov
            rest = (g1 - g0) - labelled
            if rest > 0:
                key = f"{th}: no labelled call"
                idle[key] = idle.get(key, 0.0) + rest
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], t / 1e6] for n, t in ops],
            "idle_gaps": [[f"device idle while {n}", t / 1e6]
                          for n, t in top]}


class VerifyRecorder:
    """The verification rows the check compares: in each acceptance walk
    of the window (`engine._verify_commit`, which reads the verification
    forward's node logits), one request of the cohort, drawn from the
    seed, with its context length, its tree (tokens and parents) and the
    token the program's logits rank first at each node. Nothing is
    recorded outside the window."""

    def __init__(self, eng, seed: int):
        import numpy as np
        self.np = np
        self.rng = np.random.default_rng([int(seed) & (2 ** 64 - 1),
                                          VERIFY_STREAM])
        self.rows = []
        self.on = False
        orig = eng._verify_commit

        def recorded(entries, handle=None):
            if not self.on or handle is None or not entries:
                return orig(entries, handle=handle)
            j = int(self.rng.integers(len(entries)))
            e = entries[j]
            row = dict(rid=e.req.rid, n_gen=len(e.req.generated),
                       tokens=np.array(e.tree.tokens, np.int64),
                       parent=np.array(e.tree.parent, np.int64))
            out = orig(entries, handle=handle)
            lg = handle.result()[j, : len(row["tokens"])]
            row["picks"] = np.asarray(lg).argmax(-1).astype(np.int64)
            self.rows.append(row)
            return out

        eng._verify_commit = recorded


class Cell:
    """One run of a cell: `run()` returns the run's record (see
    `metrics/`), `sent` the requests with their delivered tokens,
    `verify_rows` the verification rows recorded in the window
    (`VerifyRecorder`)."""

    def __init__(self, torch, conf: dict, plan: traffic.Plan, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 phases=None):
        self.torch = torch
        self.conf = conf
        self.plan = plan
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        #: (name, perf_counter seconds) at the end of each set-up phase
        #: before this object was made
        self.phases = list(phases or [])
        self.sent: List[Sent] = []
        self.by_rid = {}
        self.next_i = 0
        self.closed = False
        self.verify_rows = []
        self.eng = None

    # ------------------------------------------------------------ clients
    def _send(self, client: int, at: float):
        spec = self.plan.requests[self.next_i % len(self.plan.requests)]
        self.next_i += 1
        r = self.eng.submit(spec.prompt, max_new_tokens=spec.max_new,
                            domain=spec.domain,
                            arrival_ms=self.eng.backend.now_ms())
        s = Sent(client, spec, r.rid, at)
        self.sent.append(s)
        self.by_rid[r.rid] = s

    def _on_commit(self, r, toks, _now_ms):
        t = time.perf_counter()
        s = self.by_rid[r.rid]
        s.tokens.extend(int(x) for x in toks)
        s.stamps.extend([t] * len(toks))
        if r.done:
            s.done = t
            if not self.closed:
                self._send(s.client, t)

    # ---------------------------------------------------------------- run
    def run(self) -> dict:
        torch = self.torch
        phases = self.phases
        params = build_weights(torch, self.conf, self.seed, self.device)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        phases.append(("weights", time.perf_counter()))
        eng = self.eng = build_engine(torch, self.conf, self.seed,
                                      self.device, params)
        del params
        eng.on_commit = self._on_commit
        recorder = VerifyRecorder(eng, self.seed)
        tracing, prof_t0, prof_t1 = None, None, None
        if self.trace:
            tracing = Tracing(torch, eng, self.conf, self.device)
            tracing.warm()
        phases.append(("engine", time.perf_counter()))
        with eng.backend.engine_stream():
            t = time.perf_counter()
            for c in range(self.plan.clients):
                self._send(c, t)
            ramp = list(self.sent)
            ramp_steps = []
            while any(not s.stamps for s in ramp):
                t = time.perf_counter()
                if eng.step() is None:
                    raise RuntimeError("the engine drained during the ramp")
                ramp_steps.append((time.perf_counter() - t,
                                   sum(1 for s in ramp if s.stamps)))
            phases.append(("ramp", time.perf_counter()))
            for _ in range(WARM_ITERATIONS):
                eng.step()
            t_open = time.perf_counter()
            phases.append(("warm", t_open))
            setup_s = t_open - self.t_start
            n_rec0 = len(eng.stats.records)
            live_at_open = sum(1 for s in self.sent if s.done is None)
            deadline = t_open + self.seconds
            iters, prof_iters = 0, 0
            ends = [t_open]
            recorder.on = True
            while True:
                if eng.step() is None:
                    raise RuntimeError("the engine drained in the window")
                iters += 1
                if prof_t0 is not None:
                    prof_iters += 1
                now = time.perf_counter()
                ends.append(now)
                if now >= deadline:
                    break
                if tracing is not None and prof_t0 is None:
                    per_iter = (now - t_open) / iters
                    if deadline - now <= (PROFILE_ITERATIONS * per_iter
                                          * PROFILE_SLOWDOWN):
                        tracing.start()
                        prof_t0 = tracing.t_anchor
                elif prof_t0 is not None and tracing.on and \
                        prof_iters >= PROFILE_MAX_ITERATIONS:
                    tracing.stop()
                    prof_t1 = now
            t_close = now
            recorder.on = False
            self.closed = True
            if tracing is not None and tracing.on:
                tracing.stop()
                prof_t1 = t_close
        self.verify_rows = recorder.rows
        records = eng.stats.records[n_rec0:]
        off = time.perf_counter() - eng.backend.now_ms() / 1e3
        timeline = [dict(kind=s["kind"], t0=s["t0"] / 1e3 + off,
                         t1=s["t1"] / 1e3 + off)
                    for s in list(eng.backend.timeline)]
        eng.backend.shutdown()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
        marks = [("start", self.t_start)] + phases
        run = dict(
            setup_s=setup_s, t_open=t_open, t_close=t_close,
            setup_phases={b[0]: b[1] - a[1]
                          for a, b in zip(marks, marks[1:])},
            iteration_ends=ends, ramp_steps=ramp_steps,
            window_s=t_close - t_open, iterations=iters,
            sent=self.sent, live_at_open=live_at_open,
            host_t1=prof_t0 if prof_t0 is not None else t_close,
            records=[dict(batch=r.batch, committed=r.committed,
                          t1=(r.t_start_ms + r.t_iter_ms) / 1e3 + off,
                          verify_ms=r.verify_ms,
                          verify_idle_ms=r.verify_idle_ms,
                          prefill_ms=r.prefill_ms) for r in records],
            timeline=[s for s in timeline if t_open <= s["t0"] < t_close],
            memory_peak_bytes=int(peak), profile=None,
            survived=int(eng.metrics.value("pipeline.survived")),
            invalidated=int(eng.metrics.value("pipeline.invalidated")))
        if tracing is not None and prof_t0 is not None:
            run["profile"] = tracing.reduce(prof_t0, prof_t1, self.sent)
            run["profile"]["iterations"] = prof_iters
        self.eng = eng = tracing = recorder = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return run
