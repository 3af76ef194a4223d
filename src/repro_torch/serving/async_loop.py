"""Wall-clock serving loop for the `AsyncJaxBackend` (DESIGN.md §2.7).

`WallClockExecutor` is the measured twin of `pipeline.PipelineExecutor`:
the same policy sequence (admission → cohort plan → optimistic
draft-ahead → verify → reconcile), but every duration is *measured wall
time* instead of a discrete-event schedule, and the overlap is physical
rather than booked:

  * the verification forward for cohort k is dispatched to the
    backend's verification-server thread and left **in flight** while
    the engine thread drafts cohort k+1 (the GIL is released inside
    XLA, so drafter forwards and the target forward genuinely share the
    machine);
  * cold requests' prompt forwards are queued on the same server
    (`prefill_target_async`) — FIFO order guarantees the slots exist
    before the first verification that reads them — and their logits
    are resolved lazily right before the acceptance walk;
  * `device_get` of the verification logits is deferred to
    `VerifyHandle.result()`, i.e. the host transfer happens after the
    draft-ahead work has been dispatched.

  * the target-cache commit (`commit_target_async`, itself a
    verify-sized forward) is queued on the server right after the
    acceptance walk and overlaps the drafter commit + next draft on the
    engine thread; its tail logits resolve lazily at the next walk.

Accounting: the backend's `timeline` records each target task's
measured span. The verifier's bubble for a cohort is the wall gap
since the server last finished a verification, minus every task it
executed in between (prefill writes, commit extends) and minus arrival
lulls (an empty pool is not a stall). The same rule applies to the
serial and the overlapped loop, so the serial path's drafting — and
both paths' host-side walk — count as verifier idle. These feed the
same `IterationRecord` fields the simulated executors fill, so
`ServeStats`, the §2.6 trace schema and `benchmarks/wallclock.py`'s
predicted-vs-measured comparison all work unchanged.

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

import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.scheduler import PipelineObservation
from repro_torch.obs.trace import STAGE
from repro_torch.serving.events import DRAFT, VERIFY
from repro_torch.serving.pipeline import DraftJob


class WallClockExecutor:
    """One measured verification commit per `step()`. With
    `overlap=True` (pipeinfer/cosine) the next cohort is drafted while
    the current verification is in flight on the backend's worker
    thread; with `overlap=False` (vanilla/specinfer) draft and verify
    alternate — the serial coupled baseline, measured."""

    def __init__(self, engine, overlap: bool = True):
        self.eng = engine
        self.tracer = engine.tracer
        self.overlap = overlap
        self.next_job: Optional[DraftJob] = None
        self.busy_ema = 1.0
        self.conf_ema = 1.0
        self.n_survived = 0
        self.n_invalidated = 0
        # rid -> in-flight burst-prefill future (shared per burst); the
        # logits land in eng.entry_logits at _resolve_prefills time
        self._pending_prefill: Dict[int, Future] = {}
        # wall instant the verification server last finished a verify
        self._vfree = 0.0
        # arrival-lull sleep windows [(t0, t1)]: excluded from bubble
        # accounting (an empty pool is not a pipeline stall)
        self._sleeps: List[tuple] = []
        # measured cumulative busy time per stage (observation fracs)
        self._verify_busy_ms = 0.0
        self._draft_busy_ms = 0.0

    # --------------------------------------------------------------- state
    def note_dropped(self, rid: int) -> None:
        """Shed/preempt: a queued burst prefill may still admit this
        rid's slot, but the backend drop is already queued *behind* it,
        and the stale logits must never be consumed (the context could
        be re-prefilled after re-admission)."""
        self._pending_prefill.pop(rid, None)

    def observation(self, backlog: int = 0,
                    waiting: Optional[DraftJob] = None) -> PipelineObservation:
        """Measured wall occupancy since serving start. `waiting` counts
        as queue depth only if it reached the server before the server
        freed from the previous verification — same semantics as the
        simulated pipeline, against the measured `_vfree`."""
        eng = self.eng
        now = max(eng.backend.now_ms(), 1e-9)
        n = len(eng.drafters)
        dfrac = min(self._draft_busy_ms / now, 1.0)
        queued = 1 if (waiting is not None
                       and waiting.ready_ms < self._vfree) else 0
        obs = PipelineObservation(
            verify_busy_frac=min(self._verify_busy_ms / now, 1.0),
            draft_busy_frac=dfrac,
            queue_depth=queued,
            backlog=backlog,
            # no per-node wall clocks: the cluster drafts as one host
            # process, so every node reports the aggregate
            drafter_busy_fracs=[dfrac] * n,
            drafter_wait_fracs=[0.0] * n,
            spec_saturated=eng.sched.spec_saturated)
        m = eng.metrics
        m.set_gauge("pipeline.verify_busy_frac", obs.verify_busy_frac)
        m.set_gauge("pipeline.draft_busy_frac", obs.draft_busy_frac)
        m.set_gauge("pipeline.queue_depth", obs.queue_depth)
        m.set_gauge("pipeline.backlog", obs.backlog)
        for i, f in enumerate(obs.drafter_busy_fracs):
            m.set_gauge("draft.node_busy_frac", f, node=i)
        return obs

    def _observe_conf(self, entries) -> None:
        conf = float(np.mean(np.concatenate([e.fused_p for e in entries])))
        self.conf_ema = 0.7 * self.conf_ema + 0.3 * conf

    # ------------------------------------------------------------ prefill
    def _gc_prefills(self, live_rids) -> None:
        for rid in list(self._pending_prefill):
            if rid not in live_rids:
                self._pending_prefill.pop(rid, None)

    def _resolve_prefills(self, entries) -> None:
        """Land the burst-prefill logits for this cohort's cold members
        before the acceptance walk consumes them. The prefill was queued
        before this cohort's verification, so the wait (if any) ends
        strictly before the verification does."""
        eng = self.eng
        for e in entries:
            fut = self._pending_prefill.pop(e.req.rid, None)
            if fut is not None:
                eng.entry_logits[e.req.rid] = fut.result()[e.req.rid][0]

    # ------------------------------------------------------------ drafting
    def _spawn(self, prev: Optional[DraftJob]) -> Optional[DraftJob]:
        """Draft the next cohort on the engine thread (concurrent with
        `prev`'s verification in flight on the worker). Cold requests'
        target prefills are queued asynchronously; drafter prefills run
        here (the drafters' next decode needs them immediately)."""
        eng = self.eng
        inflight = ({e.req.rid: e for e in prev.entries} if prev else {})
        t_now = eng.backend.now_ms()

        def avail(r):
            if r.rid in inflight:
                return r.arrival_ms
            return eng.avail_ms.get(r.rid, r.arrival_ms)

        everyone = eng.pool.pending(float("inf"))
        self._gc_prefills({r.rid for r in everyone})
        cands = [r for r in everyone if avail(r) <= t_now]
        if not cands and prev is None:
            if not everyone:
                return None
            # real arrival lull: sleep the wall clock to the next arrival
            t_next = min(avail(r) for r in everyone)
            if t_next > t_now:
                time.sleep((t_next - t_now) / 1e3)
                self._sleeps.append((t_now, eng.backend.now_ms()))
            t_now = max(eng.backend.now_ms(), t_next)
            cands = [r for r in everyone if avail(r) <= t_now]

        def opt_ext(r):
            e = inflight.get(r.rid)
            return (e.gamma + 1) if e is not None else 0

        cands = [r for r in cands
                 if r.rid not in inflight
                 or r.max_new_tokens - len(r.generated) - opt_ext(r) > 0]
        if not cands:
            return None
        obs = self.observation(backlog=len(cands), waiting=prev)
        if eng.admission is not None:
            cands = eng._apply_admission(
                cands, t_now, obs, inflight_rids=frozenset(inflight),
                pipe_empty=prev is None)
            if not cands:
                return None
            obs = self.observation(backlog=len(cands), waiting=prev)
        cohort = eng._next_cohort()

        cold = [r for r in cands if r.rid not in eng.entry_logits
                and r.rid not in self._pending_prefill]
        if cold:
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

        extra = {r.rid: opt_ext(r) for r in cands if r.rid in inflight}
        batch, gammas = eng._plan_cohort(cands, observation=obs,
                                         extra_ctx=extra, now_ms=t_now)
        optim = {r.rid: inflight[r.rid].d_chains
                 for r in batch if r.rid in inflight}
        parts = [eng._participants(r) for r in batch]
        rids = tuple(r.rid for r in batch)
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
                        eng.n_active(entries), cohort=cohort)

    # ------------------------------------------------------------ reconcile
    def _reconcile(self, ahead: DraftJob, committed: Dict[int, List[int]],
                   t_known_ms: float) -> Optional[DraftJob]:
        """pipeline.PipelineExecutor._reconcile, measured: survivors
        shift, invalidated requests redraft on the engine thread and the
        redraft's wall time extends the job."""
        eng = self.eng
        keep, redo, invalid = [], [], []
        for e in ahead.entries:
            if e.req.done:
                continue
            if e.assumed is None:
                keep.append(e)
                continue
            toks = committed.get(e.req.rid)
            survives = (toks is not None
                        and len(toks) == len(e.assumed) + 1
                        and toks[:-1] == e.assumed
                        and toks[-1] == int(e.fused_t[0]))
            if survives:
                self.n_survived += 1
                eng.metrics.inc("pipeline.survived")
                shifted = eng._shift_entry(e)
                if shifted is not None:
                    shifted.assumed = None
                    keep.append(shifted)
                else:
                    redo.append(e.req)
            else:
                invalid.append(e.req)
                redo.append(e.req)
        self.n_invalidated += len(invalid)
        ahead.entries = keep
        if invalid:
            eng.metrics.inc("pipeline.invalidated", len(invalid))
            for r in invalid:
                self.tracer.mark("invalidate", r.rid, t_known_ms,
                                 cohort=ahead.cohort)
        if redo:
            gammas = eng._cohort_gammas(redo)
            parts = [eng._participants(r) for r in redo]
            t0 = eng.backend.now_ms()
            redo_entries = eng._draft_entries(redo, gammas, parts=parts)
            self._observe_conf(redo_entries)
            t1 = eng.backend.now_ms()
            self._draft_busy_ms += t1 - t0
            self.tracer.span("redraft", STAGE, DRAFT, t0, t1,
                             cohort=ahead.cohort,
                             rids=tuple(r.rid for r in redo))
            ahead.entries = keep + redo_entries
            ahead.draft_ms += t1 - t0
            ahead.ready_ms = max(ahead.ready_ms, t1)
            ahead.n_active = max(ahead.n_active, eng.n_active(redo_entries))
        if not ahead.entries:
            return None
        return ahead

    # ------------------------------------------------------------ one step
    def step(self):
        """One wall-clock serving iteration: draft (or reuse the
        draft-ahead job), dispatch verification, walk acceptance,
        commit, and spawn the next draft-ahead job."""
        eng = self.eng
        job, self.next_job = self.next_job, None
        if job is None:
            job = self._spawn(None)
            if job is None:
                return None

        batch = [e.req for e in job.entries]
        big_gamma = sum(e.tree.n_nodes for e in job.entries)
        # verification in flight on the worker from here on
        handle = eng._verify_dispatch(job.entries)
        # draft-ahead on this thread, physically concurrent with it
        ahead = self._spawn(job) if self.overlap else None
        self._resolve_prefills(job.entries)
        committed, total_committed = eng._verify_commit(job.entries,
                                                        handle=handle)
        vstart, vend = handle.times()
        t_llm = vend - vstart

        # measured server-side accounting: the verify server's idle for
        # this cohort is the wall gap since it last finished a verify,
        # minus every task it executed in between (prefill writes,
        # async commit extends) and minus arrival lulls (an empty pool
        # is not a pipeline stall). One uniform rule for the serial and
        # the overlapped loop — what the serial path spends drafting
        # (and both paths spend walking/committing on the host) is
        # honestly counted as verifier idle.
        spans = eng.backend.drain_timeline()
        floor = self._vfree if self._vfree > 0.0 else job.draft_start_ms
        other_busy = sum(
            min(s["t1"], vstart) - max(s["t0"], floor)
            for s in spans
            if s["kind"] != "verify"
            and s["t1"] > floor and s["t0"] < vstart)
        lull = sum(min(t1, vstart) - max(t0, floor)
                   for t0, t1 in self._sleeps
                   if t1 > floor and t0 < vstart)
        self._sleeps = [s for s in self._sleeps if s[1] > vstart]
        prefill_ms = sum(s["t1"] - s["t0"] for s in spans
                         if s["kind"] == "prefill")
        bubble = max(0.0, vstart - floor - other_busy - lull)
        self._verify_busy_ms += sum(s["t1"] - s["t0"] for s in spans)
        self.tracer.span("verify", STAGE, VERIFY, vstart, vend,
                         cohort=job.cohort,
                         rids=tuple(r.rid for r in batch))
        if bubble > 0:
            self.tracer.span("bubble", STAGE, VERIFY, vstart - bubble,
                             vstart, cohort=job.cohort,
                             rids=tuple(r.rid for r in batch),
                             cause="await_draft")
        for s in spans:
            if s["kind"] == "prefill":
                self.tracer.span("prefill", STAGE, VERIFY, s["t0"],
                                 s["t1"], cohort=job.cohort)

        wait = max(self._vfree - job.ready_ms, 0.0)
        busy_obs = (t_llm + wait) / max(t_llm + bubble, 1e-9)
        self.busy_ema = 0.6 * self.busy_ema + 0.4 * busy_obs
        self._vfree = vend

        queue_depth = 1 if (ahead is not None and ahead.ready_ms <= vend) \
            else 0
        from repro_torch.serving.engine import IterationRecord
        t_start = max(eng.clock_ms, job.draft_start_ms)
        rec = IterationRecord(
            t_start_ms=t_start, t_iter_ms=vend - t_start,
            batch=len(batch), big_gamma=big_gamma,
            committed=total_committed, n_active_drafters=job.n_active,
            cohort=job.cohort,
            draft_start_ms=job.draft_start_ms, draft_ms=job.draft_ms,
            verify_start_ms=vstart, verify_ms=t_llm,
            verify_idle_ms=bubble, prefill_ms=prefill_ms,
            queue_depth=queue_depth)
        eng._finalize(batch, committed, rec)

        if eng.strategy == "cosine":
            for e in job.entries:
                if not e.req.done:
                    eng.sched.update_gamma_feedback(
                        e.req, len(committed[e.req.rid]), self.busy_ema,
                        now_ms=vend)

        if ahead is not None:
            n_inv0 = self.n_invalidated
            ahead = self._reconcile(ahead, committed, vend)
            rec.n_invalidated = self.n_invalidated - n_inv0
        self.next_job = ahead
        return rec
