"""Multi-node drafter cluster: per-drafter stage clocks, quorum fusion,
and straggler cut-off (DESIGN.md §2.4).

The paper's speculation side is a *cluster* of heterogeneous consumer-GPU
nodes, not one serial resource. This module replaces the executor's
single draft `StageClock` with one clock per drafter node, each carrying
its own `DrafterProfile` (speed multiplier, link delay, seeded
jitter/straggler model), so the router's Eq. 3 decisions and the token
fusion of Eq. 4 are exposed to real per-node latency skew.

Cohort semantics (one drafted cohort = one `CohortSchedule`):

  * The participating nodes are split by *pace* into **fused** nodes —
    within `cut_pace_slack` of the fastest node's per-step time — and
    **cut** nodes, whose chains run free at their own pace (they would
    otherwise drag every fused step). Lock-step sync binds only fused
    nodes that *share fused requests*: per-step Eq. 4 fusion exchanges
    tokens within a request's participants, so the fused set is
    partitioned into connected components of the "co-drafts a request"
    graph and each component advances at its own slowest member's pace
    plus a component-sized sync term. Node shapes are the routed
    sub-batches the engine actually decodes (route-faithful drafting —
    see `SpeculativeEngine._draft_group`).
  * Cut chains are never allowed to block the verify clock: a chain
    whose server arrival beats the fused payload rides along for free as
    tree side branches (`role="side"`); the **confidence gate** extends
    that window by the straggler grace — when the engine's recent fused
    confidence (an EMA measured over previous cohorts, so it is known
    *before* drafting) is below `conf_gate`, the cohort waits up to the
    grace for late side chains, buying a wider tree exactly when
    speculation has been missing. Anything later is dropped
    (`role="dropped"`); `straggler_policy="drop"` drops every cut chain.
  * The cohort is ready at the server when the last *included* chain has
    arrived (each chain pays its own link delay exactly once) — a
    dropped straggler can never hold the verifier back, and no token is
    ever verified before its arrival event.

Losslessness is untouched by any of this: roles only shape *which* draft
tokens reach the verifier and *when*; greedy tree acceptance + correction
commits exactly the target's continuation regardless (tested with
extreme stragglers in tests/test_cluster.py).

All jitter/straggle draws come from one `numpy` Generator seeded at
construction and consumed in sorted-node order, so a fixed engine seed
reproduces the per-node event streams byte-for-byte.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import DrafterProfile, LatencyModel
from repro_torch.obs.trace import CLUSTER, Tracer
from repro_torch.serving.events import EventLog, StageClock

FUSED = "fused"
SIDE = "side"
DROPPED = "dropped"


@dataclass
class NodeDraft:
    """One node's share of a cohort draft."""
    node: int
    b: int                       # requests routed to this node
    step_ms: float               # per-step pace (profile * jitter, no sync)
    start_ms: float = 0.0
    end_ms: float = 0.0
    arrival_ms: float = 0.0      # chain arrival at the fusion point
    busy_ms: float = 0.0         # time placed on the node's clock
    role: str = FUSED


@dataclass
class CohortSchedule:
    """Timing plan for one cohort across the cluster (built by
    `plan_cohort`, placed on the clocks by `commit_cohort`)."""
    drafts: List[NodeDraft]
    gamma: int
    gate_ms: float
    grace_ms: float
    l: int = 0                   # cohort critical context length (per-job
    #                              pace observations / calibration)
    # when the cohort became runnable (queue-wait accounting only):
    # spawn jobs exist once the previous cohort's drafting finished,
    # redrafts once the rejection outcome is known
    release_ms: float = 0.0
    # per-request participants, possibly augmented by the coverage rider
    # (a request whose drafters were all cut is rerouted to the fastest
    # on-time node — the central scheduler never strands a request on a
    # straggling cluster slice)
    parts_by_req: Dict[int, List[int]] = field(default_factory=dict)
    start_ms: float = 0.0        # earliest node start
    fused_end_ms: float = 0.0    # lock-step group completion
    dispatch_ms: float = 0.0     # confidence-gated ship time
    ready_ms: float = 0.0        # arrival at the verification server
    draft_ms: float = 0.0        # cohort makespan (dispatch - start)
    committed: bool = False

    def roles(self) -> Dict[int, str]:
        """{node: role} for this cohort's dispatched drafts."""
        return {d.node: d.role for d in self.drafts}

    def node_busy(self) -> Dict[int, float]:
        """{node: busy ms} this cohort charged to each node."""
        return {d.node: d.busy_ms for d in self.drafts}


class DrafterCluster:
    """Per-drafter stage clocks plus the quorum/straggler policy.

    The cluster is the *timing* half of multi-node drafting; the token
    half (which proposals fuse, which become side branches, which are
    discarded) is driven by the roles this class assigns — see
    `SpeculativeEngine._draft_group`.
    """

    def __init__(self, profiles: Sequence[DrafterProfile], lat: LatencyModel,
                 cfg, log: Optional[EventLog] = None, seed: int = 0,
                 tracer: Optional[Tracer] = None):
        self.profiles: Tuple[DrafterProfile, ...] = tuple(profiles)
        self.lat = lat
        self.cfg = cfg
        self.log = log
        self.tracer = tracer
        self.nodes = [StageClock(f"draft{i}", log, tracer)
                      for i in range(len(self.profiles))]
        self._rng = np.random.default_rng((seed, 0xC1A5))
        # cumulative straggler accounting (also mirrored per record)
        self.n_cohorts = 0
        self.n_side = 0
        self.n_dropped = 0
        self.node_jobs = [0] * len(self.nodes)
        self.node_late = [0] * len(self.nodes)   # side or dropped episodes
        # per-job pace observations (b, l, step_ms) per node — the raw
        # material for profile auto-calibration (calibrated_profiles)
        self.pace_obs: List[List[Tuple[int, int, float]]] = \
            [[] for _ in self.nodes]

    # ------------------------------------------------------------- state
    def horizon_ms(self) -> float:
        """Candidate-visibility horizon: when the cluster last finished
        drafting (the single-clock executor's `free_ms` equivalent).
        Requests whose context exists by this time are drafteable in the
        next cohort; causality is still enforced per request through the
        cohort gate (cold prefill ends / warm commit times)."""
        return max(n.free_ms for n in self.nodes)

    def park_all(self, t_ms: float):
        """Arrival lull: advance every node clock without accruing idle."""
        for n in self.nodes:
            n.park(t_ms)

    def busy_fracs(self) -> Tuple[float, ...]:
        """Per-node occupancy; a node that never worked reports 0 (it is
        idle capacity, not saturation)."""
        return tuple(n.busy_frac() for n in self.nodes)

    def wait_fracs(self) -> Tuple[float, ...]:
        """Per-node chronic queueing: time jobs spent waiting for the
        node over its active span (0 for an unused node)."""
        out = []
        for n in self.nodes:
            span = n.busy_ms + n.idle_ms
            out.append(n.wait_ms / span if span > 0 else 0.0)
        return tuple(out)

    def aggregate_busy_frac(self) -> float:
        """Cluster-wide occupancy: total busy over total active span."""
        busy = sum(n.busy_ms for n in self.nodes)
        span = sum(n.busy_ms + n.idle_ms for n in self.nodes)
        return busy / span if span > 0 else 1.0

    # ---------------------------------------------------------- planning
    @staticmethod
    def _fused_components(fused: List[int],
                          parts_by_req: Dict[int, List[int]]
                          ) -> List[List[int]]:
        """Partition the on-time nodes into lock-step sync groups: two
        fused nodes synchronise iff they are connected through shared
        fused requests (per-step Eq. 4 fusion only ever exchanges tokens
        within a request's participants, so disjoint sub-batches have
        nothing to wait for)."""
        parent = {i: i for i in fused}

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        fused_set = set(fused)
        for p in parts_by_req.values():
            members = [i for i in p if i in fused_set]
            for a, b in zip(members, members[1:]):
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[ra] = rb
        comps: Dict[int, List[int]] = {}
        for i in fused:
            comps.setdefault(find(i), []).append(i)
        return [sorted(c) for c in sorted(comps.values())]

    def _jitter_mult(self, node: int) -> float:
        """Deterministic seeded jitter/straggle multiplier for one node's
        next job. Both draws are always consumed so the stream position
        is independent of the profile's parameters."""
        p = self.profiles[node]
        z = float(self._rng.standard_normal())
        u = float(self._rng.random())
        mult = math.exp(p.jitter_frac * z)
        if u < p.straggle_prob:
            mult *= p.straggle_factor
        return mult

    def plan_cohort(self, parts_by_req: Dict[int, List[int]], l: int,
                    gamma: int, gate_ms: float,
                    conf_signal: float = 1.0,
                    release_ms: Optional[float] = None) -> CohortSchedule:
        """Assign roles and compute the timing plan for one cohort.

        parts_by_req: rid -> router-selected drafter nodes.
        conf_signal: the engine's recent fused-confidence EMA (measured
        over *previous* cohorts, so roles never depend on this cohort's
        tokens); below `conf_gate` the dispatch waits the grace window
        for late side chains.

        The plan reads the node clocks but does not mutate them;
        `commit_cohort` places the work. Nothing may touch the clocks in
        between (the executor is single-stepped, so nothing does).
        """
        parts_by_req = {rid: list(p) for rid, p in parts_by_req.items()}
        parts = sorted({i for p in parts_by_req.values() for i in p})
        assert parts, "cohort with no participating nodes"
        shapes = {i: sum(1 for p in parts_by_req.values() if i in p)
                  for i in parts}
        mults = {i: self._jitter_mult(i) for i in parts}
        paces = {i: self.lat.ssm_step_node(shapes[i], l, self.profiles[i],
                                           mults[i]) for i in parts}
        fastest = min(paces.values())
        slack = self.cfg.cut_pace_slack
        fused = [i for i in parts if paces[i] <= fastest * slack]
        cut = [i for i in parts if i not in fused]

        # coverage rider: a request whose participants were all cut is
        # rerouted to the fastest on-time node (the central scheduler
        # never strands a request on a straggling cluster slice); its
        # sub-batch grows, so recompute paces — group membership is kept
        # from the pre-rider paces (the batch term is sub-ms)
        fastest_node = min(paces, key=lambda i: paces[i])
        for rid, p in parts_by_req.items():
            if not any(i in fused for i in p):
                p.append(fastest_node)
                shapes[fastest_node] += 1
        paces = {i: self.lat.ssm_step_node(shapes[i], l, self.profiles[i],
                                           mults[i]) for i in parts}

        drafts = {i: NodeDraft(i, shapes[i], paces[i]) for i in parts}
        starts = {i: max(self.nodes[i].free_ms, gate_ms) for i in parts}

        # lock-step sync binds only nodes that actually share fused
        # requests: with route-faithful sub-batches two on-time nodes
        # with disjoint sub-batches never exchange a fused token, so the
        # fused set is partitioned into connected components of the
        # "co-drafts a request" graph and each component advances at its
        # own slowest member's pace (plus a sync term sized to the
        # component, not the whole on-time set)
        max_group_step = 0.0
        for comp in self._fused_components(fused, parts_by_req):
            sync = self.lat.sync_ms(len(comp))
            group_start = max(starts[i] for i in comp)
            group_step = max(paces[i] for i in comp) + sync
            max_group_step = max(max_group_step, group_step)
            group_end = group_start + gamma * group_step
            for i in comp:
                d = drafts[i]
                d.start_ms = starts[i]
                d.end_ms = group_end
                d.busy_ms = group_end - starts[i]  # sync waits occupy the node
                d.arrival_ms = group_end \
                    + self.lat.node_comm_ms(self.profiles[i])
                d.role = FUSED
        # the fused payload is at the server once the slowest fused link
        # has delivered; a cut chain beating that time rides along free
        t_fused_arr = max(drafts[i].arrival_ms for i in fused)
        fused_end = max(drafts[i].end_ms for i in fused)

        grace = self.cfg.straggler_grace_frac * gamma * max_group_step
        policy = self.cfg.straggler_policy
        wait = conf_signal < self.cfg.conf_gate
        deadline = t_fused_arr + (grace if wait else 0.0)
        for i in cut:
            d = drafts[i]
            d.start_ms = starts[i]
            d.busy_ms = gamma * paces[i]        # free-running, no sync
            d.end_ms = starts[i] + d.busy_ms
            d.arrival_ms = d.end_ms + self.lat.node_comm_ms(self.profiles[i])
            in_time = d.arrival_ms <= deadline
            d.role = SIDE if (policy == "side" and in_time) else DROPPED

        included = [d for d in drafts.values() if d.role != DROPPED]
        sched = CohortSchedule(drafts=[drafts[i] for i in parts],
                               gamma=gamma, gate_ms=gate_ms, grace_ms=grace,
                               l=l,
                               release_ms=(gate_ms if release_ms is None
                                           else release_ms),
                               parts_by_req=parts_by_req,
                               start_ms=min(starts[i] for i in parts),
                               fused_end_ms=fused_end,
                               # last included chain leaves its node /
                               # reaches the server (per-link delay paid
                               # exactly once, inside arrival_ms)
                               dispatch_ms=max(d.end_ms for d in included),
                               ready_ms=max(d.arrival_ms for d in included))
        sched.draft_ms = sched.dispatch_ms - sched.start_ms
        return sched

    # ------------------------------------------------------ calibration
    def calibrated_profiles(self, min_jobs: int = 4
                            ) -> Tuple[DrafterProfile, ...]:
        """Fit each node's latency personality from its measured per-job
        paces (fit-style, like `LatencyModel.fit_ssm`).

        Every committed job leaves one observation (b, l, step_ms); the
        ratio of step_ms to the homogeneous step cost at that (b, l) is
        speed * jitter-multiplier, so log-ratios are `log speed` plus the
        lognormal noise. The fit is robust to straggle episodes: speed is
        the exp-median of the log-ratios and jitter_frac the MAD-based
        sigma, so occasional straggles widen jitter instead of biasing
        speed (an always-straggling node honestly calibrates to its
        effective pace). Nodes with fewer than `min_jobs` observations
        keep their configured profile (no evidence, no refit); measured
        straggle episodes are absorbed into the fitted spread, so the
        returned profiles carry straggle_prob=0."""
        base = DrafterProfile()
        out = []
        for node, obs in enumerate(self.pace_obs):
            if len(obs) < min_jobs:
                out.append(self.profiles[node])
                continue
            logr = np.array([math.log(step / self.lat.ssm_step_node(b, l,
                                                                    base))
                             for b, l, step in obs])
            med = float(np.median(logr))
            mad = float(np.median(np.abs(logr - med)))
            out.append(DrafterProfile(
                speed=math.exp(med),
                comm_ms=self.profiles[node].comm_ms,
                jitter_frac=1.4826 * mad))
        return tuple(out)

    # ----------------------------------------------------------- commit
    def commit_cohort(self, sched: CohortSchedule,
                      rids: Tuple[int, ...] = (),
                      kind: str = "draft",
                      cohort: int = -1) -> CohortSchedule:
        """Place the planned cohort on the node clocks (the plan already
        resolved roles, dispatch and ready times — token drafting happens
        between plan and commit and cannot change the timing)."""
        assert not sched.committed
        sched.committed = True
        for d in sched.drafts:
            clk = self.nodes[d.node]
            node_rids = tuple(sorted(
                rid for rid, p in sched.parts_by_req.items() if d.node in p))
            start, end, _ = clk.schedule(
                d.busy_ms, not_before_ms=sched.gate_ms,
                kind=kind if d.role == FUSED else f"{kind}_{d.role}",
                rids=node_rids or rids,
                release_ms=max(sched.gate_ms, sched.release_ms),
                cohort=cohort)
            assert abs(start - d.start_ms) < 1e-9 and abs(end - d.end_ms) < 1e-9
            self.node_jobs[d.node] += 1
            self.pace_obs[d.node].append((d.b, sched.l, d.step_ms))
            if d.role != FUSED:
                self.node_late[d.node] += 1
        if self.tracer is not None and self.tracer.enabled:
            # cluster-level activity lives on its own track: transit can
            # overlap the node's next draft (the link is not the node),
            # so these spans must not break the serial node tracks
            self.tracer.instant("fuse", CLUSTER, "cluster",
                                sched.fused_end_ms, cohort=cohort,
                                rids=rids, kind=kind)
            for d in sched.drafts:
                if d.role == DROPPED:
                    self.tracer.instant("drop", CLUSTER, "cluster",
                                        d.end_ms, cohort=cohort,
                                        node=d.node, kind=kind)
                else:
                    self.tracer.span("transit", CLUSTER, "cluster",
                                     d.end_ms, d.arrival_ms, cohort=cohort,
                                     node=d.node, role=d.role, kind=kind)
        self.n_cohorts += 1
        self.n_side += sum(1 for d in sched.drafts if d.role == SIDE)
        self.n_dropped += sum(1 for d in sched.drafts if d.role == DROPPED)
        if self.log is not None:
            late = tuple(d.node for d in sched.drafts if d.role != FUSED)
            if late:
                self.log.emit(sched.dispatch_ms, "cluster", "straggler_cut",
                              rids, info=",".join(
                                  f"{d.node}:{d.role}" for d in sched.drafts
                                  if d.role != FUSED))
        return sched
