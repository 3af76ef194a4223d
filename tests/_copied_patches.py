"""The deliberate changes to the port's copies of the framework-free
modules (`test_torch_package.py::test_copied_module_equals_original`):
for each copy, (original, port) pairs of source text, each original
found once in the JAX package's module. The port's side is written with
the package name mapped back (`repro_torch.` as `repro.`), as the test
compares it.

* `obs.export`: the reference's `build_metrics` reads
  `engine.executor.log`, which the wall-clock executor does not have, so
  exporting an async engine's metrics fails there.
* `obs.trace`, `obs.metrics`: their notes on threads. Under the
  wall-clock backend two threads write spans (through the port's
  `obs.wall.WallTracer`, under a lock) and host-read counters (each
  thread its own, labelled).
* `serving.async_loop`: its docstring names the port's backend and its
  tracing; the loop's own wall spans (`iteration`, `prefill`, `draft`
  and `redraft` on the wall path, the `admit` instant) and the engine
  thread's host-read counting.
"""

PATCHES = {
    "obs.export": [(
        """    if engine.executor is not None:
        m.set_gauge("obs.events_dropped", engine.executor.log.n_dropped)""",
        """    log = getattr(engine.executor, "log", None)
    if log is not None:
        m.set_gauge("obs.events_dropped", log.n_dropped)""")],
    "obs.trace": [
        ('''Span identity is deterministic: `seq` is a global monotone counter in
host execution order (single-threaded serving loop), and the exported id
is derived from (track, cohort, rid, name, seq); all times come from the
simulated stage clocks. Two same-seed runs therefore produce
byte-identical exports (tested), which is the validation contract the
future async wall-clock loop must satisfy against this executor.

''',
         '''Span identity is deterministic: `seq` is a global monotone counter in
host execution order (the simulated serving loop is single-threaded; the
wall-clock loop's two threads write through `obs.wall.WallTracer`, which
orders them under a lock), and the exported id is derived from (track,
cohort, rid, name, seq); all times come from the simulated stage
clocks. Two same-seed runs therefore produce byte-identical exports
(tested). The wall-clock loop emits the same schema from measured time.

'''),
    ],
    "obs.metrics": [
        ('''``draft.node_tokens{node=3}``. Everything is plain Python floats/ints —
no deps, no locks (the serving loop is single-threaded), and
`to_dict()` is deterministically ordered so a metrics JSON export is
byte-identical across same-seed runs.

''',
         '''``draft.node_tokens{node=3}``. Everything is plain Python floats/ints —
no deps, no locks (no counter has two writing threads: under the
wall-clock backend the server thread writes only the host-read counters
labelled ``thread=server``, `obs.wall`), and `to_dict()` is
deterministically ordered so a metrics JSON export is byte-identical
across same-seed runs.

'''),
    ],
    "serving.async_loop": [
        ('''"""Wall-clock serving loop for the `AsyncJaxBackend` (DESIGN.md §2.7).

''',
         '''"""Wall-clock serving loop for the `AsyncTorchBackend` (DESIGN.md §2.7).

'''),
        ('''    backend's verification-server thread and left **in flight** while
    the engine thread drafts cohort k+1 (the GIL is released inside
    XLA, so drafter forwards and the target forward genuinely share the
    machine);
  * cold requests' prompt forwards are queued on the same server
    (`prefill_target_async`) — FIFO order guarantees the slots exist
    before the first verification that reads them — and their logits
    are resolved lazily right before the acceptance walk;
  * `device_get` of the verification logits is deferred to
    `VerifyHandle.result()`, i.e. the host transfer happens after the
''',
         '''    backend's verification-server thread and left **in flight** while
    the engine thread drafts cohort k+1 (on CUDA the two threads launch
    on streams of their own, so the card runs both; their host work
    shares one interpreter lock, which each torch call releases and
    takes back);
  * cold requests' prompt forwards are queued on the same server
    (`prefill_target_async`) — FIFO order guarantees the slots exist
    before the first verification that reads them — and their logits
    are resolved lazily right before the acceptance walk;
  * the host copy of the verification logits is deferred to
    `VerifyHandle.result()`, i.e. the host transfer happens after the
'''),
        ('''same `IterationRecord` fields the simulated executors fill, so
`ServeStats`, the §2.6 trace schema and `benchmarks/wallclock.py`'s
predicted-vs-measured comparison all work unchanged.

Losslessness is inherited: the token-level math is identical to the
simulated path (same `_draft_entries` / `_verify_commit`), so greedy
tree acceptance + correction always commits the target's greedy
continuation — tested in tests/test_backend.py against the AR
reference, including under admission churn.
"""
from __future__ import annotations
''',
         '''same `IterationRecord` fields the simulated executors fill, so
`ServeStats` and the §2.6 trace schema work unchanged.

Tracing (`CoSineConfig.enable_tracing`) adds wall spans of the engine
thread (`obs.wall.WallTracer.wall`): ``iteration`` (one `step`), ``prefill`` (a
cohort's cold requests: the target's prefill queued, the drafters'
run), ``draft`` / ``redraft`` (stage spans, as before), and inside the
engine's calls ``draft.step``, ``draft.extend``, ``wait.verify``,
``walk`` and ``commit.drafters``; an ``admit`` instant when a request's
first target prefill is queued; and the host reads of every step,
counted under ``thread=engine``.

Losslessness is inherited: the token-level math is identical to the
simulated path (same `_draft_entries` / `_verify_commit`), so greedy
tree acceptance + correction always commits the target's greedy
continuation — tested in tests/test_backend.py against the AR
reference, including under admission churn.
"""
# A copy of `repro.serving.async_loop` (the framework-free policy): in the
# port the backend it drives is `serving.backend.AsyncTorchBackend`, whose
# verification server runs the target on a CUDA stream of its own while
# this loop drafts on the engine thread's stream.
from __future__ import annotations
'''),
        ('''from repro.obs.trace import STAGE
from repro.serving.events import DRAFT, VERIFY
''',
         '''from repro.obs.trace import STAGE
from repro.obs import wall as _wall
from repro.serving.events import DRAFT, VERIFY
'''),
        ('''        if cold:
            for r in cold:
                if r.n_preemptions > 0 and r.generated:
                    eng.tracer.mark("readmit", r.rid, t_now)
            ctxs = {r.rid: list(r.prompt) + r.generated for r in cold}
            # one masked slot_extend on the verification server, in
            # flight while we prefill the drafters and draft below
            fut = eng.backend.prefill_target_async(ctxs)
            for r in cold:
                self._pending_prefill[r.rid] = fut
            lls = eng.backend.prefill_drafters(
                {rid: c[:-1] for rid, c in ctxs.items()})
            if eng.strategy == "cosine" and eng.cfg.enable_routing:
                for rid in ctxs:
                    eng.router.set_prior(rid, lls[rid])

''',
         '''        if cold:
            with self.tracer.wall("prefill", _wall.ENGINE, cohort=cohort,
                                  rids=tuple(r.rid for r in cold)):
                for r in cold:
                    if r.n_preemptions > 0 and r.generated:
                        eng.tracer.mark("readmit", r.rid, t_now)
                ctxs = {r.rid: list(r.prompt) + r.generated for r in cold}
                # one masked slot_extend on the verification server, in
                # flight while we prefill the drafters and draft below
                fut = eng.backend.prefill_target_async(ctxs)
                t_q = eng.backend.now_ms()
                for r in cold:
                    self._pending_prefill[r.rid] = fut
                    # its first prefill (only an admitted request is
                    # ever preempted)
                    if r.n_preemptions == 0:
                        eng.tracer.mark("admit", r.rid, t_q)
                lls = eng.backend.prefill_drafters(
                    {rid: c[:-1] for rid, c in ctxs.items()})
                if eng.strategy == "cosine" and eng.cfg.enable_routing:
                    for rid in ctxs:
                        eng.router.set_prior(rid, lls[rid])

'''),
        ('''        rids = tuple(r.rid for r in batch)
        t0 = eng.backend.now_ms()
        entries = eng._draft_entries(batch, gammas, optimistic=optim,
                                     parts=parts)
        for e in entries:
            if e.req.rid in optim:
                e.assumed = [int(t) for t in inflight[e.req.rid].fused_t]
        self._observe_conf(entries)
        t1 = eng.backend.now_ms()
        self._draft_busy_ms += t1 - t0
        self.tracer.span("draft", STAGE, DRAFT, t0, t1, cohort=cohort,
                         rids=rids)
        return DraftJob(entries, t0, t1 - t0, t1,
''',
         '''        rids = tuple(r.rid for r in batch)
        with self.tracer.wall("draft", DRAFT, cat=STAGE, cohort=cohort,
                              rids=rids):
            t0 = eng.backend.now_ms()
            entries = eng._draft_entries(batch, gammas, optimistic=optim,
                                         parts=parts)
            for e in entries:
                if e.req.rid in optim:
                    e.assumed = [int(t) for t in inflight[e.req.rid].fused_t]
            self._observe_conf(entries)
            t1 = eng.backend.now_ms()
        self._draft_busy_ms += t1 - t0
        return DraftJob(entries, t0, t1 - t0, t1,
'''),
        ('''            parts = [eng._participants(r) for r in redo]
            t0 = eng.backend.now_ms()
            redo_entries = eng._draft_entries(redo, gammas, parts=parts)
            self._observe_conf(redo_entries)
            t1 = eng.backend.now_ms()
            self._draft_busy_ms += t1 - t0
            self.tracer.span("redraft", STAGE, DRAFT, t0, t1,
                             cohort=ahead.cohort,
                             rids=tuple(r.rid for r in redo))
            ahead.entries = keep + redo_entries
''',
         '''            parts = [eng._participants(r) for r in redo]
            with self.tracer.wall("redraft", DRAFT, cat=STAGE,
                                  cohort=ahead.cohort,
                                  rids=tuple(r.rid for r in redo)):
                t0 = eng.backend.now_ms()
                redo_entries = eng._draft_entries(redo, gammas, parts=parts)
                self._observe_conf(redo_entries)
                t1 = eng.backend.now_ms()
            self._draft_busy_ms += t1 - t0
            ahead.entries = keep + redo_entries
'''),
        ('''        draft-ahead job), dispatch verification, walk acceptance,
        commit, and spawn the next draft-ahead job."""
        eng = self.eng
        job, self.next_job = self.next_job, None
        if job is None:
            job = self._spawn(None)
            if job is None:
                return None

''',
         '''        draft-ahead job), dispatch verification, walk acceptance,
        commit, and spawn the next draft-ahead job. Traced as the wall
        span ``iteration``, its host reads counted for the engine."""
        if self.tracer.clock is None:
            return self._step(_wall.OFF)
        with _wall.counting_host_reads(self.eng.metrics, _wall.ENGINE), \\
                self.tracer.wall("iteration", _wall.ENGINE) as it:
            return self._step(it)

    def _step(self, it):
        eng = self.eng
        job, self.next_job = self.next_job, None
        if job is None:
            job = self._spawn(None)
            if job is None:
                return None
        # the server tasks this iteration queues carry its cohort
        it.cohort = job.cohort

'''),
    ],
}
