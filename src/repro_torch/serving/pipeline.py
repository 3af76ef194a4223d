"""Discrete-event decoupled pipeline executor (paper §4.3 Alg. 2,
PipeInfer-style decoupling; DESIGN.md §2).

The speculation side is a *multi-node drafter cluster* — one `StageClock`
per drafter node with its own latency profile (serving/cluster.py,
DESIGN.md §2.4) — feeding a serial verification server:

  drafter nodes (draft0..draftN)  --tokens-->  verification server ("verify")

A cohort fans out across the router-selected nodes, fuses when the
confidence-gated quorum arrives, and cuts stragglers loose (late chains
join the side-branch tree or are dropped — they never block the verify
clock). The cluster drafts cohort i+1 while the server verifies i. For
requests whose iteration-i verification is still in flight, drafting
proceeds *optimistically* on slot snapshots: the drafter state is
teacher-forced over the iteration-i fused chain (assumed fully accepted)
and the chain simply continues. The assumption matrices (`d_chains`,
(N, gamma) per request) are consumed per node: `_draft_group` slices
each node's rows down to its routed sub-batch before teacher-forcing,
and redraft cohorts re-slice against their own (freshly routed) parts.
When the verification lands, each dependent draft is reconciled against
the actually committed tokens:

  * survive — every assumed token was accepted AND the verifier's
    correction token equals the ahead-draft's first fused token; the
    remaining chain (shifted by one) is a valid draft on the new
    committed state and goes to verification as-is.
  * invalidate — anything else; the entry is re-drafted from the real
    committed state (`kind="redraft"` on the draft stage), and the
    verifier's next start is pushed out accordingly. This is the
    pipelined price of a rejection — it shows up as measured bubble
    time, not as a formula term.

Losslessness is preserved unconditionally: every tree that reaches
`_verify_commit` is rooted at the *true* committed context (survivor
shifts included), and greedy tree acceptance + correction token always
commits exactly the target's greedy continuation regardless of what the
drafts contain.

Timing semantics (DESIGN.md §2.2): draft->verify transfers pay
`comm_ms`; verification outcomes stream back to the central node with
the commit decision, so a redraft may begin at the verification's end
time (the return path overlaps the verification tail — sub-ms token
payloads). A cold request's prompt forward is a *prefill job on the
verify stage* (`LatencyModel.t_prefill`) that gates its first draft, so
TTFT includes the cold-start prefill under bursty arrivals. Verifier
idle (bubble) time, queueing, and stage occupancy are all *measured*
off the event timeline; nothing here consults the analytic
`iteration_pipelined` formula.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.scheduler import PipelineObservation
from repro_torch.serving.cluster import DrafterCluster
from repro_torch.serving.events import DRAFT, VERIFY, EventLog, StageClock


@dataclass
class DraftJob:
    """One drafted cohort in flight between the stages."""
    entries: List["DraftEntry"]          # noqa: F821 (engine.DraftEntry)
    draft_start_ms: float
    draft_ms: float
    ready_ms: float                      # arrival at the verification server
    n_active: int
    cohort: int = -1                     # engine-global cohort seq (trace id)
    # per-drafter-node busy time spent on this cohort (draft + redrafts)
    node_busy: Dict[int, float] = field(default_factory=dict)
    n_straggler_side: int = 0
    n_straggler_dropped: int = 0


class PipelineExecutor:
    """Advances one verification commit per `step()` call; the draft
    cluster runs (at most) one cohort ahead of the verifier. Drafting is
    fanned out across the router-selected nodes of a `DrafterCluster`,
    each with its own stage clock and latency profile (DESIGN.md §2.4)."""

    def __init__(self, engine):
        self.eng = engine
        self.tracer = engine.tracer
        self.log = EventLog(max_events=engine.cfg.obs_max_events)
        self.cluster = DrafterCluster(engine.drafter_profiles, engine.lat,
                                      engine.cfg, self.log,
                                      seed=engine.seed, tracer=self.tracer)
        self.verify = StageClock(VERIFY, self.log, self.tracer)
        self.next_job: Optional[DraftJob] = None
        # measured verifier occupancy (EMA) consumed by Alg. 2's adaptive
        # speculation feedback; >1 means drafted work queued at the server
        self.busy_ema = 1.0
        # fused-confidence EMA over committed cohorts: the cluster's
        # dispatch gate (wait for late side chains only when recent
        # speculation has been low-confidence). Starts optimistic.
        self.conf_ema = 1.0
        self.n_survived = 0
        self.n_invalidated = 0
        # prefill time scheduled on the verify stage since the last
        # IterationRecord (attributed to the record that observes it)
        self._prefill_acc_ms = 0.0
        # verify free time *before* the in-flight verification was placed
        # (step() schedules the verification before spawning the ahead
        # cohort, so prefills queue behind it; the queue-depth observation
        # must still compare against the pre-verification free time)
        self._vfree_before = 0.0

    # --------------------------------------------------------------- state
    def note_dropped(self, rid: int) -> None:
        """Shed/preempt notification (the wall-clock executor invalidates
        pending prefills here; the simulated pipeline holds no per-request
        executor state)."""

    def observation(self, backlog: int = 0,
                    waiting: Optional[DraftJob] = None) -> PipelineObservation:
        """`waiting` is a drafted cohort not yet picked up by the server;
        it counts as queue depth only if it reached the server before the
        server freed up from the *previous* verification (i.e. it is
        genuinely sitting in the queue)."""
        queued = 1 if (waiting is not None
                       and waiting.ready_ms < self._vfree_before) else 0
        obs = PipelineObservation(
            verify_busy_frac=self.verify.busy_frac(),
            draft_busy_frac=self.cluster.aggregate_busy_frac(),
            queue_depth=queued,
            backlog=backlog,
            drafter_busy_fracs=self.cluster.busy_fracs(),
            drafter_wait_fracs=self.cluster.wait_fracs(),
            spec_saturated=self.eng.sched.spec_saturated)
        # mirror the measured state into the registry so the metrics
        # export shows what the controllers last saw (DESIGN.md §2.6)
        m = self.eng.metrics
        m.set_gauge("pipeline.verify_busy_frac", obs.verify_busy_frac)
        m.set_gauge("pipeline.draft_busy_frac", obs.draft_busy_frac)
        m.set_gauge("pipeline.queue_depth", obs.queue_depth)
        m.set_gauge("pipeline.backlog", obs.backlog)
        for i, f in enumerate(obs.drafter_busy_fracs):
            m.set_gauge("draft.node_busy_frac", f, node=i)
        return obs

    def _observe_conf(self, entries) -> None:
        """Fold a drafted cohort's fused confidences into the EMA the
        *next* cohort's dispatch gate consumes."""
        conf = float(np.mean(np.concatenate([e.fused_p for e in entries])))
        self.conf_ema = 0.7 * self.conf_ema + 0.3 * conf

    # ------------------------------------------------------------ drafting
    def _spawn_job(self, prev: Optional[DraftJob]) -> Optional[DraftJob]:
        """Draft the next cohort on the draft stage.

        prev is the cohort currently awaiting verification: its requests
        are drafted ahead optimistically (assumed fully accepted). With
        no prev (cold pipe) the cluster idles until the next arrival."""
        eng = self.eng
        inflight = ({e.req.rid: e for e in prev.entries} if prev else {})
        t_vis = self.cluster.horizon_ms()

        def avail(r):
            # an in-flight request's optimistic continuation is legal as
            # soon as its previous draft exists; a fresh request only once
            # its current committed context does (arrival / last commit)
            if r.rid in inflight:
                return r.arrival_ms
            return eng.avail_ms.get(r.rid, r.arrival_ms)

        everyone = eng.pool.pending(float("inf"))
        cands = [r for r in everyone if avail(r) <= t_vis]
        if not cands and prev is None:
            if not everyone:
                return None
            t_vis = min(avail(r) for r in everyone)
            cands = [r for r in everyone if avail(r) <= t_vis]
            self.cluster.park_all(t_vis)  # lull: no work existed, not a bubble

        def opt_ext(r):     # optimistic tokens this commit would add
            e = inflight.get(r.rid)
            return (e.gamma + 1) if e is not None else 0

        # skip requests that (optimistically) complete at the pending
        # commit; if a rejection keeps them alive they re-enter next round
        cands = [r for r in cands
                 if r.rid not in inflight
                 or r.max_new_tokens - len(r.generated) - opt_ext(r) > 0]
        if not cands:
            return None
        # admission control (DESIGN.md §2.5), before any prefill is
        # charged: shed/queue decisions consume the measured saturation
        # state, in-flight requests are auto-admitted (their commit is
        # imminent), and preemption victims release their slots here —
        # their re-admission pays a fresh prefill below once re-admitted
        obs = self.observation(backlog=len(cands), waiting=prev)
        if eng.admission is not None:
            cands = eng._apply_admission(
                cands, t_vis, obs, inflight_rids=frozenset(inflight),
                pipe_empty=prev is None)
            if not cands:
                return None
            obs = self.observation(backlog=len(cands), waiting=prev)
        cohort = eng._next_cohort()
        cold = [r for r in cands if r.rid not in eng.entry_logits]
        for r in cold:
            # cold request: the prompt forward occupies the
            # verification server and gates drafting, so TTFT is
            # honest under bursty arrivals (no free prefills)
            t_pf = eng.lat.t_prefill(r.context_len)
            self.verify.park(avail(r))   # arrival lull != bubble
            _, pend, _ = self.verify.schedule(
                t_pf, not_before_ms=avail(r), kind="prefill",
                rids=(r.rid,), cohort=cohort)
            eng.avail_ms[r.rid] = pend
            self._prefill_acc_ms += t_pf
        eng._ensure_prefilled_batch(
            cold, now_of={r.rid: avail(r) for r in cold})
        extra = {r.rid: opt_ext(r) for r in cands if r.rid in inflight}
        batch, gammas = eng._plan_cohort(
            cands, observation=obs, extra_ctx=extra, now_ms=t_vis)
        optim = {r.rid: inflight[r.rid].d_chains
                 for r in batch if r.rid in inflight}

        K = max(gammas)
        l = max(r.context_len + extra.get(r.rid, 0) for r in batch)
        rids = tuple(r.rid for r in batch)
        # drafting cannot start before every cold member's prefill landed
        # nor before a warm member's context was committed; per-node
        # availability is enforced by the node clocks themselves (the
        # horizon is NOT part of the gate — a cut node running long must
        # never delay the next cohort's on-time nodes)
        gate = max([0.0] + [avail(r) for r in batch
                            if r.rid not in inflight])
        # fan the cohort out across the router-selected drafter nodes:
        # the cluster assigns roles (on-time fused quorum / side / cut)
        # and the confidence-gated dispatch before token drafting — pace
        # depends only on profiles + seeded jitter, and the gate consumes
        # the fused-confidence EMA measured over *previous* cohorts, so
        # nothing about the timing can depend on this cohort's tokens
        parts_by_req = {r.rid: eng._participants(r) for r in batch}
        plan = self.cluster.plan_cohort(parts_by_req, l, K, gate,
                                        conf_signal=self.conf_ema,
                                        release_ms=max(gate, t_vis))
        roles = plan.roles()
        entries = eng._draft_entries(
            batch, gammas, optimistic=optim,
            parts=[plan.parts_by_req[r.rid] for r in batch], roles=roles)
        for e in entries:
            if e.req.rid in optim:
                e.assumed = [int(t) for t in inflight[e.req.rid].fused_t]

        self._observe_conf(entries)
        sched = self.cluster.commit_cohort(plan, rids, kind="draft",
                                           cohort=cohort)
        for node, role in roles.items():
            eng.router.note_node_outcome(node, role)
        n_active = eng.n_active(entries)
        drops = [d.role for d in sched.drafts]
        return DraftJob(entries, sched.start_ms, sched.draft_ms,
                        sched.ready_ms, n_active, cohort=cohort,
                        node_busy=sched.node_busy(),
                        n_straggler_side=drops.count("side"),
                        n_straggler_dropped=drops.count("dropped"))

    # ------------------------------------------------------------ reconcile
    def _reconcile(self, ahead: DraftJob, committed: Dict[int, List[int]],
                   t_known_ms: float) -> Optional[DraftJob]:
        """Resolve the ahead cohort's optimistic assumptions against the
        tokens the verification actually committed. Runs after _finalize,
        so completed requests are marked done and the drafter slot caches
        hold the new committed state for redrafting."""
        eng = self.eng
        keep, redo, invalid = [], [], []
        for e in ahead.entries:
            if e.req.done:
                continue                      # finished at commit: wasted work
            if e.assumed is None:
                keep.append(e)                # was not dependent on the commit
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
                    shifted.assumed = None    # now rooted at real state
                    keep.append(shifted)
                else:
                    # gamma==1: the whole ahead draft was consumed by the
                    # commit — a full hit, not an invalidation; it just
                    # needs fresh tokens
                    redo.append(e.req)
            else:
                invalid.append(e.req)
                redo.append(e.req)
        self.n_invalidated += len(invalid)
        ahead.entries = keep
        if invalid:
            self.log.emit(t_known_ms, DRAFT, "invalidate",
                          tuple(r.rid for r in invalid))
            eng.metrics.inc("pipeline.invalidated", len(invalid))
            for r in invalid:
                self.tracer.mark("invalidate", r.rid, t_known_ms,
                                 cohort=ahead.cohort)
        if redo:
            gammas = eng._cohort_gammas(redo)
            K = max(gammas)
            l = max(r.context_len for r in redo)
            parts_by_req = {r.rid: eng._participants(r) for r in redo}
            plan = self.cluster.plan_cohort(parts_by_req, l, K, t_known_ms,
                                            conf_signal=self.conf_ema)
            roles = plan.roles()
            redo_entries = eng._draft_entries(
                redo, gammas,
                parts=[plan.parts_by_req[r.rid] for r in redo], roles=roles)
            self._observe_conf(redo_entries)
            sched = self.cluster.commit_cohort(
                plan, tuple(r.rid for r in redo), kind="redraft",
                cohort=ahead.cohort)
            for node, role in roles.items():
                eng.router.note_node_outcome(node, role)
            n_active = eng.n_active(redo_entries)
            ahead.entries = keep + redo_entries
            ahead.draft_ms += sched.draft_ms
            ahead.ready_ms = max(ahead.ready_ms, sched.ready_ms)
            ahead.n_active = max(ahead.n_active, n_active)
            for node, busy in sched.node_busy().items():
                ahead.node_busy[node] = ahead.node_busy.get(node, 0.0) + busy
            drops = [d.role for d in sched.drafts]
            ahead.n_straggler_side += drops.count("side")
            ahead.n_straggler_dropped += drops.count("dropped")
        if not ahead.entries:
            return None
        return ahead

    # ------------------------------------------------------------ one step
    def step(self):
        """One discrete-event serving iteration on the simulated
        clocks: consume or spawn the draft job, schedule verification
        on the verify StageClock, walk acceptance, commit, and leave
        the next draft-ahead job pending."""
        eng = self.eng
        job, self.next_job = self.next_job, None
        if job is None:
            job = self._spawn_job(None)
            if job is None:
                return None

        # ---- verification ----
        # scheduled *before* the ahead cohort is spawned: new arrivals'
        # prefill jobs then queue behind this already-ready verification
        # instead of preempting it, and its bubble is measured honestly
        batch = [e.req for e in job.entries]
        b = len(batch)
        l = max(r.context_len for r in batch)
        big_gamma = sum(e.tree.n_nodes for e in job.entries)
        t_llm = eng.lat.t_llm(b, l, big_gamma)
        # idle before this cohort's drafting even began is an arrival lull
        # (nothing verifiable could have existed), not a pipeline bubble —
        # the coupled baselines' analytic accounting excludes lulls too
        self.verify.park(job.draft_start_ms)
        vfree0 = self.verify.free_ms
        vstart, vend, bubble = self.verify.schedule(
            t_llm, not_before_ms=job.ready_ms, kind="verify",
            rids=tuple(r.rid for r in batch), cohort=job.cohort,
            cause="await_draft")
        self._vfree_before = vfree0

        # draft-ahead for the next iteration, concurrent with this verify
        ahead = self._spawn_job(job)
        committed, total_committed = eng._verify_commit(job.entries)

        # measured occupancy: wait>0 means the cohort queued at the server
        wait = max(vfree0 - job.ready_ms, 0.0)
        busy_obs = (t_llm + wait) / max(t_llm + bubble, 1e-9)
        self.busy_ema = 0.6 * self.busy_ema + 0.4 * busy_obs

        queue_depth = 1 if (ahead is not None and ahead.ready_ms <= vend) \
            else 0
        from repro_torch.serving.engine import IterationRecord
        # an iteration starts when its cohort's drafting did (arrival
        # lulls sit between records, as in the coupled path's clock jumps)
        t_start = max(eng.clock_ms, job.draft_start_ms)
        rec = IterationRecord(
            t_start_ms=t_start, t_iter_ms=vend - t_start,
            batch=b, big_gamma=big_gamma, committed=total_committed,
            n_active_drafters=job.n_active, cohort=job.cohort,
            draft_start_ms=job.draft_start_ms, draft_ms=job.draft_ms,
            verify_start_ms=vstart, verify_ms=t_llm,
            verify_idle_ms=bubble, prefill_ms=self._prefill_acc_ms,
            queue_depth=queue_depth,
            node_busy_ms=tuple(job.node_busy.get(i, 0.0)
                               for i in range(len(eng.drafters))),
            n_straggler_side=job.n_straggler_side,
            n_straggler_dropped=job.n_straggler_dropped)
        self._prefill_acc_ms = 0.0
        eng._finalize(batch, committed, rec)

        # Alg. 2 adaptive control driven by *observed* occupancy
        if eng.strategy == "cosine":
            for e in job.entries:
                if not e.req.done:
                    eng.sched.update_gamma_feedback(
                        e.req, len(committed[e.req.rid]), self.busy_ema,
                        now_ms=vend)

        # resolve the ahead cohort against what actually committed
        if ahead is not None:
            n_inv0 = self.n_invalidated
            ahead = self._reconcile(ahead, committed, vend)
            rec.n_invalidated = self.n_invalidated - n_inv0
        self.next_job = ahead
        return rec
