"""SLO-aware admission control (DESIGN.md §2.5).

Under sustained overload the scheduler's batch assignment alone only
decides *who goes first* — nothing bounds how long the rest wait, and a
saturated verifier silently degrades every request's latency. The
admission layer sits between the request pool and the scheduler and
turns `PipelineObservation` saturation into explicit policy:

  * **queue** — cold (zero-token) requests beyond the admission cap are
    withheld from the scheduler's candidate set this cohort; they stay
    in the pool and age (the scheduler's aging credit guarantees they
    are eventually batched once admitted).
  * **shed** — a cold request that can no longer meet its deadline even
    if served alone (now + minimal service time > deadline) is rejected
    outright while the verifier saturates; serving it would be pure
    goodput loss. Overflow past the queue cap is shed worst-first
    (lowest priority class, latest deadline). Only zero-token requests
    are ever shed — a stream that has started always runs to completion
    (never half-committed).
  * **preempt** — when the batch is full of lower-priority in-flight
    requests and a more urgent class is waiting, the lowest-priority
    victim's slots are evicted (the cheap slot evict/re-admit path: its
    committed tokens survive in the pool; re-admission re-prefills
    prompt+generated and pays that prefill on the verify stage).
    Preemption is churn-damped: a request is evicted at most once in
    its lifetime, never once it is >= 75% complete, and at most one
    slot is evicted per admission pass.

Invariants: started requests are never shed; requests in the in-flight
verification cohort are never preempted (their caches are about to be
extended by the commit); when the pipe is empty the controller always
admits at least one candidate, so admission can never deadlock the
serve loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.config import CoSineConfig
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.request_pool import Request
from repro_torch.core.scheduler import PipelineObservation
from repro_torch.obs.metrics import DecisionLog


@dataclass
class AdmissionDecision:
    """Outcome of one admission pass over the cohort candidates."""
    admit: List[Request] = field(default_factory=list)
    queued: List[Request] = field(default_factory=list)
    shed: List[Request] = field(default_factory=list)
    preempt: List[Request] = field(default_factory=list)   # active victims


class ServiceTimeEstimator:
    """Measured per-token service time under the *current* load
    (DESIGN.md §2.5): an EMA over observed iteration wall time divided
    by the tokens it committed, scaled to one request's share of the
    batch. The shed test consumes this instead of the analytic
    single-request optimum `t_llm(1, l, min_gamma)`, which is wildly
    optimistic exactly when admission matters — under saturation a cold
    request shares the verifier with a full batch. Estimate changes
    beyond 10% are recorded through the DecisionLog so the shed
    decisions' evidence trail is auditable."""

    def __init__(self, alpha: float = 0.3,
                 decisions: Optional[DecisionLog] = None):
        self.alpha = alpha
        self.decisions = decisions
        self.ms_per_tok: Optional[float] = None
        self._logged: float = 0.0
        self.n_obs = 0

    def observe(self, iter_ms: float, committed: int, batch: int,
                now_ms: float = 0.0) -> None:
        """One serving iteration: `batch` requests shared `iter_ms` of
        engine time and committed `committed` tokens, so one request's
        marginal cost is iter_ms * batch / committed per token."""
        if committed <= 0 or iter_ms <= 0:
            return
        obs = iter_ms * max(batch, 1) / committed
        if self.ms_per_tok is None:
            self.ms_per_tok = obs
        else:
            self.ms_per_tok += self.alpha * (obs - self.ms_per_tok)
        self.n_obs += 1
        if self.decisions is not None and (
                self._logged <= 0.0
                or abs(self.ms_per_tok - self._logged) > 0.1 * self._logged):
            self.decisions.record(now_ms, "service_est",
                                  ms_per_tok=self.ms_per_tok,
                                  n_obs=self.n_obs)
            self._logged = self.ms_per_tok


class AdmissionController:
    def __init__(self, cfg: CoSineConfig, lat: LatencyModel,
                 decisions: Optional[DecisionLog] = None):
        self.cfg = cfg
        self.lat = lat
        # controller decision log (DESIGN.md §2.6): each pass's verdict
        # is recorded with the saturation inputs it keyed on
        self.decisions = decisions
        # measured service-time evidence, fed by engine._finalize
        self.svc = ServiceTimeEstimator(decisions=decisions)

    # ----------------------------------------------------------- helpers
    def min_service_ms(self, r: Request) -> float:
        """Time-to-first-token estimate for the shed test. With measured
        evidence: prefill plus one committed token at the observed
        ms/token under current load. Before any iteration has been
        observed (cold start), the optimistic analytic bound — prefill
        plus one minimal solo verification — so a fresh controller
        never sheds on a guess."""
        pf = self.lat.t_prefill(r.context_len)
        if self.svc.ms_per_tok is not None:
            return pf + self.svc.ms_per_tok
        return (pf + self.lat.comm_ms
                + self.lat.t_llm(1, r.context_len, self.cfg.min_gamma))

    @staticmethod
    def _urgency(r: Request):
        """Shed/queue order: keep high priority classes and early
        deadlines, break ties by arrival."""
        return (r.priority, r.deadline_ms, r.arrival_ms, r.rid)

    # ------------------------------------------------------------ decide
    def decide(self, cands: Sequence[Request], now_ms: float,
               observation: Optional[PipelineObservation] = None,
               active: Sequence[Request] = (),
               n_protected: int = 0,
               pipe_empty: bool = False) -> AdmissionDecision:
        """Partition the cohort candidates.

        cands: schedulable requests (pool.pending filtered by arrival).
        active: requests currently holding slots that are legal
          preemption victims (prefilled, NOT in the in-flight
          verification cohort).
        n_protected: slot-holders that are *not* legal victims (the
          in-flight cohort) — they still occupy batch capacity.
        pipe_empty: nothing drafted or verifying — the controller must
          admit work if any exists.
        """
        cfg = self.cfg
        dec = AdmissionDecision()
        saturated = observation is not None and observation.saturated \
            and not pipe_empty

        started = [r for r in cands if r.generated]
        cold = sorted((r for r in cands if not r.generated),
                      key=self._urgency)
        dec.admit.extend(started)

        # --- shed: hopeless deadlines (only under saturation — with a
        # free verifier a late request still produces tokens at no cost
        # to anyone else, so it is served best-effort) ---
        if cfg.shed_when_late and saturated:
            keep = []
            for r in cold:
                if now_ms + self.min_service_ms(r) > r.deadline_ms:
                    dec.shed.append(r)
                else:
                    keep.append(r)
            cold = keep

        # --- queue cap: bound the cold backlog under saturation; the
        # overflow past 2x the cap is shed (worst-first order is already
        # applied), between cap and 2x it merely queues ---
        if cfg.admit_queue_cap > 0 and saturated \
                and len(cold) > cfg.admit_queue_cap:
            over = cold[cfg.admit_queue_cap:]
            cold = cold[: cfg.admit_queue_cap]
            dec.queued.extend(over[: cfg.admit_queue_cap])
            dec.shed.extend(over[cfg.admit_queue_cap:])

        dec.admit.extend(cold)
        # liveness floor: with an empty pipe, admission must hand the
        # scheduler at least one request if any candidate survived
        if not dec.admit and dec.queued:
            dec.admit.append(dec.queued.pop(0))

        # --- priority preemption: urgent cold arrivals displace the
        # lowest-priority active slots when the batch is full. Only
        # under saturation: with verifier headroom the scheduler batches
        # the arrival next cohort anyway, so eviction would just burn a
        # re-prefill. Damped against churn — every eviction costs a
        # re-prefill, so a request is only ever evicted once, never when
        # it is mostly done (>= 75% of its tokens committed), and at
        # most one slot is evicted per admission pass ---
        if cfg.preempt_priority and saturated and active:
            eligible = [v for v in sorted(active, key=self._urgency,
                                          reverse=True)
                        if v.n_preemptions == 0
                        and 4 * len(v.generated) < 3 * v.max_new_tokens]
            waiting = sorted((r for r in dec.admit if not r.generated),
                             key=self._urgency)
            slots_free = cfg.max_batch - n_protected - len(active)
            for hi in waiting:
                if slots_free > 0:
                    slots_free -= 1     # room without preempting
                    continue
                if not eligible:
                    break
                if hi.priority < eligible[0].priority:
                    dec.preempt.append(eligible.pop(0))
                break                   # one eviction per pass

        if self.decisions is not None and (cands or active):
            self.decisions.record(
                now_ms, "admission",
                n_cands=len(cands), saturated=saturated,
                pipe_empty=pipe_empty,
                queue_depth=(observation.queue_depth
                             if observation is not None else 0),
                verify_busy_frac=(observation.verify_busy_frac
                                  if observation is not None else 0.0),
                svc_ms_per_tok=(self.svc.ms_per_tok
                                if self.svc.ms_per_tok is not None else -1.0),
                admitted=tuple(r.rid for r in dec.admit),
                queued=tuple(r.rid for r in dec.queued),
                shed=tuple(r.rid for r in dec.shed),
                preempted=tuple(r.rid for r in dec.preempt))
        return dec
