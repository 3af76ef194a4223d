"""Collaborative pipeline component (paper §4.3, Eq. (5)–(8), Alg. 2):
batch assignment + adaptive speculation control.

The batch assignment problem (Eq. 8) — minimize T_ttl/b + lambda*Gamma
subject to the token budget (Eq. 6), latency SLO and memory cap (Eq. 7) —
is a small 0/1 program re-solved every iteration. We solve it the way the
paper's 0.1 ms "lightweight LP solver" does: candidate batches are prefixes
of the length-sorted request list (batched latency is dominated by the
longest member, so optimal batches are length-contiguous), with
AdaptiveSpeculation trimming per-request draft counts gamma_i to the
budget (Alg. 2 lines 17–20).

Under the decoupled executor (DESIGN.md §2) the scheduler additionally
sees the pipeline's *measured* state: a `PipelineObservation` carries the
verify-queue depth and the busy fractions of both stages as observed on
the event timeline, and `update_gamma_feedback` consumes that observed
verifier occupancy instead of an analytic busy ratio. The `t_ttl`
estimate inside `plan()` remains analytic — it is a planning heuristic;
the executor measures what actually happens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import CoSineConfig
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.request_pool import Request
from repro_torch.obs.metrics import DecisionLog


@dataclass
class PipelineObservation:
    """Measured executor state fed back into planning (DESIGN.md §2.3).

    verify_busy_frac / draft_busy_frac: busy time over active span,
    measured from the event timeline (not the analytic model).
    queue_depth: drafted cohorts waiting for the verification server.
    backlog: admitted requests the scheduler has not yet placed.
    drafter_busy_fracs / drafter_wait_fracs: per-drafter-node occupancy
    and queue-wait (time jobs sat waiting for the node, as a fraction of
    its active span), measured off each node's stage clock (DESIGN.md
    §2.4) — empty tuples under the coupled baselines.
    """
    verify_busy_frac: float = 1.0
    draft_busy_frac: float = 1.0
    queue_depth: int = 0
    backlog: int = 0
    drafter_busy_fracs: Tuple[float, ...] = ()
    drafter_wait_fracs: Tuple[float, ...] = ()
    # drafting can no longer cover verification even at the per-request
    # gamma ceiling (balance_gamma hit cfg.gamma_max): the pipeline is
    # verify-bound no matter how much is drafted, so feedback must not
    # discount lambda to "draft more"
    spec_saturated: bool = False

    @property
    def saturated(self) -> bool:
        """Verifier saturation signal the admission layer keys on:
        drafted work already queued at the server, or the verify stage
        essentially never idle."""
        return self.queue_depth > 0 or self.verify_busy_frac > 0.95

    @property
    def hottest_drafter_frac(self) -> float:
        """Occupancy of the most saturated drafter node (falls back to
        the aggregate when per-node data is unavailable)."""
        return max(self.drafter_busy_fracs, default=self.draft_busy_frac)

    @property
    def max_drafter_wait_frac(self) -> float:
        """Worst chronic queueing across the drafter nodes."""
        return max(self.drafter_wait_fracs, default=0.0)


def adaptive_speculation(gammas: List[int], gamma_max_total: int,
                         min_gamma: int = 1) -> List[int]:
    """Alg. 2 AdaptiveSpeculation: while sum gamma_i exceeds Gamma_max,
    decrement the largest gamma_j (never below min_gamma)."""
    g = list(gammas)
    while sum(g) > gamma_max_total:
        j = int(np.argmax(g))
        if g[j] <= min_gamma:
            break
        g[j] -= 1
    return g


@dataclass
class BatchPlan:
    requests: List[Request]
    gammas: List[int]
    t_ssm_ms: float
    t_llm_ms: float
    t_ttl_ms: float
    objective: float

    @property
    def big_gamma(self) -> int:
        return sum(self.gammas)


class RequestScheduler:
    def __init__(self, cfg: CoSineConfig, lat: LatencyModel,
                 mem_per_token_bytes: float = 0.0,
                 decisions: Optional[DecisionLog] = None):
        self.cfg = cfg
        self.lat = lat
        self.mem_per_token = mem_per_token_bytes
        # controller decision log (DESIGN.md §2.6): every λ-multiplier
        # update, SLO trim, balance cap and feedback step is recorded
        # with its inputs so feedback behaviour is auditable
        self.decisions = decisions
        # set by balance_gamma: drafting cannot cover verification even
        # at cfg.gamma_max (surfaced via PipelineObservation)
        self.spec_saturated = False

    def balance_gamma(self, b: int, l: int, n_drafters: int = 1,
                      now_ms: float = 0.0) -> int:
        """Pipeline-balancing draft length: smallest gamma whose drafting
        time covers the verification time (keeps the verifier busy without
        over-drafting — the adaptive speculation control signal).

        Capped at cfg.gamma_max: when drafting never covers verification
        (a fast cluster against a slow server) there is no balancing
        gamma, and over-drafting past the per-request ceiling would only
        inflate verification volume. The condition is remembered as
        `spec_saturated` and surfaced through `PipelineObservation` so
        feedback stops discounting lambda to "draft more"."""
        g_cap = max(self.cfg.gamma_max, self.cfg.min_gamma)
        for gamma in range(1, g_cap + 1):
            t_d = self.lat.t_ssm(b, l, gamma, n_drafters)
            t_v = self.lat.t_llm(b, l, b * gamma)
            if t_d >= t_v:
                self.spec_saturated = False
                if self.decisions is not None:
                    self.decisions.record(now_ms, "balance_gamma", b=b, l=l,
                                          gamma=gamma, saturated=False)
                return gamma
        self.spec_saturated = True
        if self.decisions is not None:
            self.decisions.record(now_ms, "balance_gamma", b=b, l=l,
                                  gamma=g_cap, saturated=True)
        return g_cap

    def effective_lam(self, observation: Optional[PipelineObservation],
                      now_ms: float = 0.0) -> float:
        """Observation-conditioned lambda for Eq. (8).

        Queue pressure raises it (trim speculation when drafted work is
        already waiting on the verifier); a starved verifier lowers it —
        but only while the backlog is shallow: with more waiting requests
        than a batch can hold, extra speculation per request would just
        delay them. A saturated (or chronically queued) drafter node
        while the verifier has slack means drafting is the bottleneck,
        so speculation is trimmed. The composed multiplier is clamped to
        [lam_mult_min, lam_mult_max] — the raw multipliers compose
        multiplicatively and would otherwise run away when both stages
        saturate — and a deadband below each busy-fraction threshold
        keeps the signal from flapping when a stage hovers at its
        setpoint."""
        cfg = self.cfg
        if observation is None:
            return cfg.lam
        dead = cfg.lam_deadband
        mult = 1.0 + observation.queue_depth
        if observation.verify_busy_frac < 0.8 - dead \
                and observation.backlog <= cfg.max_batch \
                and not observation.spec_saturated:
            mult *= 0.5                      # verifier starved: draft more
        if (observation.hottest_drafter_frac > 0.95
                or observation.max_drafter_wait_frac > 0.2) \
                and observation.verify_busy_frac < 0.95 - dead:
            mult *= 2.0                      # drafting is the bottleneck
        mult = min(max(mult, cfg.lam_mult_min), cfg.lam_mult_max)
        if self.decisions is not None:
            self.decisions.record(
                now_ms, "lam", mult=mult, lam=cfg.lam * mult,
                queue_depth=observation.queue_depth,
                backlog=observation.backlog,
                verify_busy_frac=observation.verify_busy_frac,
                hottest_drafter_frac=observation.hottest_drafter_frac,
                max_drafter_wait_frac=observation.max_drafter_wait_frac,
                spec_saturated=observation.spec_saturated)
        return cfg.lam * mult

    def slo_gamma(self, r: Request, now_ms: float,
                  pipelined: bool = True) -> int:
        """SpecServe-style per-request speculation trimming: the draft
        length an SLO-constrained request should run this iteration.

        With ample headroom this is just the request's adaptive gamma
        (capped at cfg.gamma_max). As the deadline approaches, the
        per-token latency budget shrinks; speculation deeper than the
        budget allows only adds drafting time ahead of each commit, so
        gamma is walked down until the estimated iteration time per
        committed token fits the remaining budget (never below
        min_gamma — an overdue request still speculates minimally)."""
        cfg = self.cfg
        g = min(r.gamma, cfg.gamma_max)
        # trimming never *raises* gamma — a request already below
        # min_gamma keeps its own value (plan must not exceed it)
        floor = min(cfg.min_gamma, g)
        if not cfg.slo_trim or r.deadline_ms == float("inf"):
            return g
        headroom = r.headroom_ms(now_ms)
        if headroom <= 0.0:
            if floor != g and self.decisions is not None:
                self.decisions.record(now_ms, "slo_gamma", rid=r.rid,
                                      gamma_from=g, gamma_to=floor,
                                      headroom_ms=headroom,
                                      budget_per_tok_ms=0.0)
            return floor
        remaining = max(r.max_new_tokens - len(r.generated), 1)
        budget_per_tok = headroom / remaining
        l = r.context_len
        exp_acc = max(r.l_acc_ema, 1.0)

        def ms_per_tok(g_: int) -> float:
            t_d = self.lat.t_ssm(1, l, g_) + self.lat.comm_ms
            t_v = self.lat.t_llm(1, l, g_)
            t_it = max(t_d, t_v) if pipelined else t_d + t_v
            # acceptance is bounded by the draft length (+1 correction)
            return t_it / min(exp_acc + 1.0, g_ + 1.0)

        g0 = g
        while g > floor and ms_per_tok(g) > budget_per_tok:
            g -= 1
        if g != g0 and self.decisions is not None:
            self.decisions.record(now_ms, "slo_gamma", rid=r.rid,
                                  gamma_from=g0, gamma_to=g,
                                  headroom_ms=headroom,
                                  budget_per_tok_ms=budget_per_tok)
        return g

    def plan(self, requests: Sequence[Request], pipelined: bool = True,
             n_drafters: int = 1, n_nodes: int = 0,
             observation: Optional[PipelineObservation] = None,
             extra_ctx: Optional[Dict[int, int]] = None,
             now_ms: float = 0.0) -> BatchPlan:
        """Solve Eq. (8) over aged-length-sorted prefixes.

        observation: measured pipeline state, folded into the effective
          lambda (see `effective_lam`).
        n_nodes: cluster size. With route-faithful sub-batching each of
          the n_nodes drafters decodes only its routed share, so the
          drafting estimate charges the expected per-node sub-batch
          ceil(b * n_drafters / n_nodes) instead of the cohort width —
          per-node load is real content now, and the plan's t_ssm must
          track the occupancy the hot-node trim acts on.
        extra_ctx: rid -> extra context tokens assumed beyond the
          committed state (draft-ahead plans against optimistic lengths).
        now_ms: planning time, for queue-age aging and SLO headroom.
          Candidates are ordered by *effective* length — context length
          minus an aging credit (age_tok_per_ms per waited ms, plus a
          priority-class bonus) — so a long-context request that has
          waited long enough sorts ahead of fresh short ones and cannot
          starve behind the 4*max_batch candidate bound (and, since the
          batch prefixes follow the same order, cannot be starved by the
          objective either). The critical length fed to the latency
          model stays the *real* max context of the batch.
        """
        cfg = self.cfg
        lam = self.effective_lam(observation, now_ms=now_ms)
        ctx_of = (lambda r: r.context_len + (extra_ctx or {}).get(r.rid, 0))

        def aged_len(r: Request) -> float:
            age = max(now_ms - r.arrival_ms, 0.0) \
                + cfg.priority_age_bonus_ms * (1 - r.priority)
            return ctx_of(r) - cfg.age_tok_per_ms * age

        def draft_b(b: int) -> int:
            if n_nodes > 1 and cfg.subbatch_drafting:
                return max(1, -(-b * min(n_drafters, n_nodes) // n_nodes))
            return b

        cand = sorted(requests,
                      key=lambda r: (aged_len(r), r.arrival_ms, r.rid))
        cand = cand[: 4 * cfg.max_batch]          # bound the search
        # SLO trimming is per-request, independent of the batch prefix —
        # computed once per plan (also keeps the decision log to one
        # entry per trimmed request, not one per candidate prefix)
        slo_of = {r.rid: self.slo_gamma(r, now_ms, pipelined) for r in cand}
        best: BatchPlan | None = None
        for b in range(1, min(len(cand), cfg.max_batch) + 1):
            sel = cand[:b]
            l = max(ctx_of(r) for r in sel)
            gam = adaptive_speculation(
                [slo_of[r.rid] for r in sel],
                cfg.gamma_max_total, cfg.min_gamma)
            big_g = sum(gam)
            t_ssm = self.lat.t_ssm(draft_b(b), l, max(gam), n_drafters)
            t_llm = self.lat.t_llm(b, l, big_g)
            t_ttl = (max(t_ssm + self.lat.comm_ms, t_llm) if pipelined
                     else t_ssm + self.lat.comm_ms + t_llm)
            if t_ttl > cfg.t_max_ms:
                continue
            mem = sum(ctx_of(r) + g for r, g in zip(sel, gam)) \
                * self.mem_per_token
            if mem > cfg.m_max_bytes:
                continue
            # Eq. (8): latency-per-request with a verified-token budget term.
            obj = t_ttl / b + lam * big_g
            plan = BatchPlan(sel, gam, t_ssm, t_llm, t_ttl, obj)
            if best is None or obj < best.objective:
                best = plan
        if best is None and cand:   # SLO-infeasible: serve the shortest alone
            r = cand[0]
            g = [max(self.cfg.min_gamma,
                     min(r.gamma, self.cfg.gamma_max,
                         self.cfg.gamma_max_total))]
            t_ssm = self.lat.t_ssm(draft_b(1), ctx_of(r), g[0], n_drafters)
            t_llm = self.lat.t_llm(1, ctx_of(r), g[0])
            best = BatchPlan([r], g, t_ssm, t_llm,
                             t_ssm + self.lat.comm_ms + t_llm, float("inf"))
        return best

    def update_gamma_feedback(self, request: Request, n_committed: int,
                              verifier_busy_frac: float,
                              now_ms: float = 0.0):
        """Alg. 2 adaptive control: grow gamma when the verifier has slack
        and drafts are being accepted; shrink when overloaded/rejected.

        Under the decoupled executor `verifier_busy_frac` is the measured
        occupancy of the verification stage (busy over busy+bubble, with
        queued cohorts pushing it above 1) — observed on the event
        timeline, not derived from the latency formulas. The coupled
        baselines still pass their analytic t_llm/t_iter ratio."""
        g0 = request.gamma
        if verifier_busy_frac < 0.8 and n_committed >= request.gamma:
            request.gamma = min(request.gamma + 1, self.cfg.gamma_max)
        elif verifier_busy_frac > 1.2 or n_committed <= 1:
            request.gamma = max(request.gamma - 1, self.cfg.min_gamma)
        if request.gamma != g0 and self.decisions is not None:
            self.decisions.record(now_ms, "gamma_feedback", rid=request.rid,
                                  gamma_from=g0, gamma_to=request.gamma,
                                  n_committed=n_committed,
                                  verifier_busy_frac=verifier_busy_frac)
