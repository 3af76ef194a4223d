"""The CoSine serving engine (paper §4) and its baselines (port of
`repro.serving.engine`; the policy code is the reference's, the models
run on PyTorch through the port's backend).

Strategies (DESIGN.md §1):
  ar         — vLLM-style incremental decoding (no speculation)
  vanilla    — single-drafter chain speculation, coupled execution
  specinfer  — all drafters draft independent chains, merged into a token
               tree, coupled (synchronous) execution
  pipeinfer  — single-drafter chain, decoupled pipelined execution
  cosine     — the paper: adaptive routing (Eq. 1-3) + confidence-based
               token fusion (Eq. 4) + tree verification + collaborative
               pipeline (Eq. 5-8, Alg. 2)

Execution model (DESIGN.md §2): `ar`/`vanilla`/`specinfer` run the
coupled path — draft, then verify, strictly in sequence, with the
iteration charged by the analytic `LatencyModel.iteration_coupled`.
`pipeinfer`/`cosine` run on the discrete-event `PipelineExecutor`
(serving/pipeline.py): the speculation cluster and the verification
server advance separate simulated clocks, the cluster drafts iteration
i+1 (optimistically, on slot snapshots) while the server verifies
iteration i, and draft/verify overlap — including verifier bubbles,
queueing, and draft-ahead invalidation on rejection — is *measured from
the event timeline* rather than assumed by a formula.

Token-level computation (drafting, verification, acceptance) is executed
for real by the PyTorch models; wall-clock of the paper's heterogeneous
GPU deployment is accounted by the calibrated LatencyModel (DESIGN.md §3),
so latency/throughput/cost metrics are reported in *simulated* deployment
time while correctness (losslessness) is real.

Cache ownership: each ModelRunner owns one slot-based device-resident
cache (continuous batching); the engine addresses requests by rid and the
runner's SlotCacheManager maps rids to slots. Prefill admits a slot,
completion evicts it, and speculative drafting runs on discarded slot
snapshots — there is no per-request cache dict or per-step host
stack/split anywhere in the serving path. Drafter caches are kept one
token *behind* the committed stream (prefilled on ctx[:-1], committed
with [prev, toks[:-1]]) so the draft loop's first `decode(prev)` feeds
the last committed token exactly once — drafter chains condition on the
same context the target verifies (DESIGN.md §1.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import CoSineConfig, ModelConfig
from repro_torch.core import tree as tree_mod
from repro_torch.core.admission import AdmissionController
from repro_torch.core.latency_model import (DrafterProfile, LatencyModel,
                                      pool_profiles)
from repro_torch.core.request_pool import Request, RequestPool
from repro_torch.models.quantize import resolve_drafter_quant
from repro_torch.core.routing import AdaptiveRouter
from repro_torch.core.scheduler import (PipelineObservation, RequestScheduler,
                                  adaptive_speculation)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import STAGE, Tracer
from repro_torch.serving.backend import (ExecutionBackend, VerifyHandle,
                                         make_backend)
from repro_torch.serving.events import DRAFT, VERIFY

STRATEGIES = ("ar", "vanilla", "specinfer", "pipeinfer", "cosine")
PIPELINED_STRATEGIES = ("pipeinfer", "cosine")


def _softmax_f32(logits) -> np.ndarray:
    """Row softmax in float32 (drafter confidences)."""
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@dataclass
class IterationRecord:
    """Accounting for one serving iteration (one cohort through
    draft -> verify -> commit)."""

    t_start_ms: float
    t_iter_ms: float
    batch: int
    big_gamma: int
    committed: int
    n_active_drafters: int
    # cohort sequence number (engine-global, monotone): joins this
    # record to its trace spans and decision-log entries (DESIGN.md §2.6)
    cohort: int = -1
    # --- stage-level timeline (DESIGN.md §2.2): measured on the event
    # clocks for pipelined strategies, analytic decomposition for the
    # coupled baselines (where the verifier provably idles during
    # drafting and communication).
    draft_start_ms: float = 0.0
    draft_ms: float = 0.0
    verify_start_ms: float = 0.0
    verify_ms: float = 0.0
    verify_idle_ms: float = 0.0          # bubble before this verification
    prefill_ms: float = 0.0              # prompt forwards charged to the
    #                                      verify stage this iteration
    queue_depth: int = 0                 # drafted cohorts waiting at commit
    n_invalidated: int = 0               # draft-ahead entries rejected
    # --- per-drafter cluster accounting (DESIGN.md §2.4): busy time each
    # node spent on this iteration's cohort (draft + any redrafts), and
    # how many chains were demoted to side branches / dropped outright by
    # the straggler policy. Empty/zero under the coupled baselines.
    node_busy_ms: Tuple[float, ...] = ()
    n_straggler_side: int = 0
    n_straggler_dropped: int = 0


@dataclass
class ServeStats:
    """Serving aggregates, backed by the metrics registry (DESIGN.md
    §2.6): the engine increments registry counters as it serves, and the
    legacy fields are read-only views over them — the registry is the
    single source, so a metrics JSON export and these properties can
    never disagree. Per-iteration detail stays in `records`."""
    records: List[IterationRecord] = field(default_factory=list)
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)

    def add_record(self, rec: IterationRecord):
        """Fold one iteration into the registry. Increment order mirrors
        the old per-record sums exactly (same float accumulation), so
        equality tests against the stage clocks keep holding."""
        self.records.append(rec)
        m = self.metrics
        m.inc("serve.iterations")
        m.inc("serve.committed_tokens", rec.committed)
        m.inc("serve.drafted_tokens", rec.big_gamma)
        m.inc("verify.busy_ms", rec.verify_ms + rec.prefill_ms)
        m.inc("verify.prefill_ms", rec.prefill_ms)
        m.inc("verify.idle_ms", rec.verify_idle_ms)
        m.observe("serve.iter_ms", rec.t_iter_ms)
        m.observe("serve.commit_per_iter", rec.committed)
        m.observe("serve.batch_size", rec.batch)

    def note_draft_work(self, node: int, n_nodes: int, n_tokens: int):
        """Charge `n_tokens` drafter token-decodes to `node`."""
        g = self.metrics.gauge("draft.n_nodes")
        if g.value < n_nodes:
            g.set(n_nodes)
        self.metrics.inc("draft.node_tokens", n_tokens, node=node)
        self.metrics.inc("draft.calls", n_tokens)

    def note_shed(self):
        """Count one admission rejection."""
        self.metrics.inc("admission.shed")

    def note_preempt(self):
        """Count one priority preemption (slot eviction)."""
        self.metrics.inc("admission.preempted")

    @property
    def total_committed(self) -> int:
        """Tokens committed across all requests."""
        return int(self.metrics.value("serve.committed_tokens"))

    @property
    def total_drafted(self) -> int:
        """Draft tokens proposed across all cohorts."""
        return int(self.metrics.value("serve.drafted_tokens"))

    # --- admission-control outcomes (DESIGN.md §2.5) ---
    @property
    def n_shed(self) -> int:
        """Requests rejected by admission."""
        return int(self.metrics.value("admission.shed"))

    @property
    def n_preempted(self) -> int:
        """Slot evictions (priority preemption)."""
        return int(self.metrics.value("admission.preempted"))

    # --- route-faithful drafting compute (DESIGN.md §2.4) ---
    @property
    def draft_calls(self) -> int:
        """Total drafter token-decodes executed: the sum over cohorts and
        nodes of K * |sub-batch|. With routed sub-batches this is ~k*B*K
        per cohort; the legacy full fan-out paid N*B*K."""
        return int(self.metrics.value("draft.calls"))

    @property
    def node_drafted(self) -> List[int]:
        """node_drafted[i]: token-decodes node i executed (its routed
        sub-batch sizes times the draft length, over cohorts+redrafts)."""
        n = int(self.metrics.value("draft.n_nodes"))
        return [int(self.metrics.value("draft.node_tokens", node=i))
                for i in range(n)]

    @property
    def sim_ms(self) -> float:
        """Simulated end time of the last iteration (ms)."""
        return (self.records[-1].t_start_ms + self.records[-1].t_iter_ms
                if self.records else 0.0)

    @property
    def throughput_tps(self) -> float:
        """Committed tokens per simulated second."""
        return self.total_committed / max(self.sim_ms / 1000.0, 1e-9)

    @property
    def mean_acceptance(self) -> float:
        """Mean committed tokens per iteration."""
        return self.total_committed / max(len(self.records), 1)

    # --- pipeline health (DESIGN.md §2.2) ---
    @property
    def verifier_busy_ms(self) -> float:
        """Verification + prefill forwards: everything occupying the
        verification server (matches the executor's verify StageClock)."""
        return self.metrics.value("verify.busy_ms")

    @property
    def prefill_busy_ms(self) -> float:
        """Prefill share of the verification server's busy time."""
        return self.metrics.value("verify.prefill_ms")

    @property
    def verifier_idle_ms(self) -> float:
        """Total pipeline bubble time observed ahead of verifications."""
        return self.metrics.value("verify.idle_ms")

    @property
    def verifier_utilization(self) -> float:
        """busy / (busy + idle) of the verification server."""
        busy, idle = self.verifier_busy_ms, self.verifier_idle_ms
        return busy / max(busy + idle, 1e-9)

    @property
    def n_invalidated(self) -> int:
        """Draft-ahead cohorts invalidated by acceptance divergence."""
        return sum(r.n_invalidated for r in self.records)

    # --- drafter cluster health (DESIGN.md §2.4) ---
    @property
    def drafter_busy_ms(self) -> Tuple[float, ...]:
        """Per-node busy time summed over all iteration records."""
        width = max((len(r.node_busy_ms) for r in self.records), default=0)
        out = [0.0] * width
        for r in self.records:
            for i, v in enumerate(r.node_busy_ms):
                out[i] += v
        return tuple(out)

    @property
    def n_straggler_side(self) -> int:
        """Late drafter proposals demoted to side branches."""
        return sum(r.n_straggler_side for r in self.records)

    @property
    def n_straggler_dropped(self) -> int:
        """Late drafter proposals dropped outright."""
        return sum(r.n_straggler_dropped for r in self.records)


@dataclass
class DraftEntry:
    """One request's drafted speculation for one iteration.

    `d_toks`/`d_confs` (N, gamma) are every drafter's proposals (router
    evidence + tree side branches); `d_chains` (N, gamma) are the tokens
    each drafter actually *consumed* while chaining (equal to the fused
    chain when fusion is on) — the teacher-forcing script that recreates
    the drafter state for optimistic draft-ahead. `assumed`, when set,
    is the context extension beyond the committed stream this draft was
    conditioned on (draft-ahead); it is resolved against the actually
    committed tokens when the depended-on verification lands.
    """
    req: Request
    gamma: int
    tree: tree_mod.TokenTree
    fused_t: np.ndarray                  # (gamma,) fused main chain
    fused_p: np.ndarray                  # (gamma,) fused confidences
    d_toks: np.ndarray                   # (N, gamma)
    d_confs: np.ndarray                  # (N, gamma)
    d_chains: np.ndarray                 # (N, gamma)
    parts: List[int]
    assumed: Optional[List[int]] = None


class SpeculativeEngine:
    """The serving engine: admission, routing, drafting cohorts,
    tree verification, acceptance and commit over an execution
    backend (policy here, mechanism in `serving.backend` —
    DESIGN.md §2.7). `strategy` picks the serving flow (`STRATEGIES`):
    plain AR, SpecInfer fan-out, PipeInfer, or CoSine's routed
    collaborative drafting."""

    def __init__(self, target: Tuple[ModelConfig, dict],
                 drafters: Sequence[Tuple[ModelConfig, dict, str]],
                 cosine: CoSineConfig, strategy: str = "cosine",
                 latency: Optional[LatencyModel] = None,
                 max_len: int = 512, seed: int = 0,
                 eos_token: Optional[int] = None,
                 drafter_profiles: Optional[Sequence[DrafterProfile]] = None,
                 backend=None, device=None):
        """`device`: where the backend's runners run — CUDA unless
        "cpu" is asked for (params must already live there)."""
        assert strategy in STRATEGIES, strategy
        self.strategy = strategy
        self.cfg = cosine
        self.eos = eos_token
        self.seed = seed
        self.target_cfg = target[0]
        # weight-only drafter quantization (DESIGN.md §2.9): resolve each
        # node's mode (ModelConfig.quant overrides the pool-wide
        # cosine.drafter_quant default) and calibrate-and-swap int8
        # params BEFORE the backend builds its runners.
        drafters = resolve_drafter_quant(list(drafters),
                                         cosine.drafter_quant)
        # engine/backend split (DESIGN.md §2.7): the backend owns the
        # runners, the caches and the serving clock; `backend` is "sim"
        # (default — the discrete-event seed behaviour), "async" (the
        # wall-clock AsyncTorchBackend) or a ready ExecutionBackend.
        # `self.target`/`self.drafters` stay as runner aliases for
        # calibration and tests; the serving path goes through
        # `self.backend` only.
        self.backend: ExecutionBackend = make_backend(
            backend, target, drafters, max_len,
            paged=cosine.paged_pool, page_size=cosine.page_size,
            pool_pages=cosine.pool_pages, device=device)
        self.backend.bind(self)
        self.target = self.backend.target
        self.drafters = self.backend.drafters
        self.drafter_domains = [d for _, _, d in drafters]
        self.lat = latency or LatencyModel()
        self.pool = RequestPool()
        # telemetry (DESIGN.md §2.6): one registry + tracer per engine;
        # the controllers share the registry's decision log
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=cosine.enable_tracing,
                             max_spans=cosine.obs_max_events)
        self.router = AdaptiveRouter(len(self.drafters), cosine,
                                     self.target.embed_np, seed)
        self.sched = RequestScheduler(cosine, self.lat,
                                      decisions=self.metrics.decisions)
        self.admission = (AdmissionController(
            cosine, self.lat, decisions=self.metrics.decisions)
            if cosine.enable_admission else None)
        self.stats = ServeStats(metrics=self.metrics)
        self.clock_ms = 0.0
        self._cohort_seq = 0
        self.entry_logits: Dict[int, np.ndarray] = {}
        # rid -> simulated time its current committed context exists from
        # (arrival, then each commit); drafting a request earlier would
        # violate causality in the event timeline
        self.avail_ms: Dict[int, float] = {}
        self.rng = np.random.default_rng(seed)
        # heterogeneous cluster personalities (per-drafter stage clocks,
        # DESIGN.md §2.4); default is the seed's homogeneous behaviour,
        # except that int8 weight-only nodes default to the faster
        # INT8_DRAFT_SPEED pace (calibrated_profiles() then recovers the
        # realized pace from measured per-cohort step times)
        self.drafter_profiles = (tuple(drafter_profiles) if drafter_profiles
                                 else pool_profiles(
                                     [c for c, _, _ in drafters]))
        assert len(self.drafter_profiles) == len(self.drafters)
        # SSM/hybrid verifiers cannot apply tree masks -> chain-only trees
        self.tree_capable = self.target_cfg.family not in ("ssm", "hybrid")
        # streaming hook: called as on_commit(request, tokens, now_ms)
        # after every commit (request.done already reflects completion)
        self.on_commit: Optional[Callable] = None
        # wall-clock backends commit the target cache asynchronously on
        # the verification server; the returned tail logits are only
        # consumed by the *next* acceptance walk, so they resolve lazily
        self._tails_fut = None
        if self.backend.is_wallclock:
            assert strategy != "ar", \
                "async backend serves speculative strategies; use the " \
                "simulated backend for the ar baseline"
            from repro_torch.serving.async_loop import WallClockExecutor
            self.executor = WallClockExecutor(
                self, overlap=strategy in PIPELINED_STRATEGIES)
        elif strategy in PIPELINED_STRATEGIES:
            from repro_torch.serving.pipeline import PipelineExecutor
            self.executor = PipelineExecutor(self)
        else:
            self.executor = None

    # ------------------------------------------------------------ requests
    def submit(self, prompt, max_new_tokens: int = 32, domain=None,
               arrival_ms: float = 0.0, priority: int = 1,
               slo_ms: Optional[float] = None) -> Request:
        """slo_ms: per-request latency budget (deadline = arrival + slo);
        defaults to cfg.default_slo_ms. priority: class (0 high, 1
        normal, 2 low) consumed by the scheduler's aging credit and the
        admission layer's shed/preempt ordering."""
        budget = self.cfg.default_slo_ms if slo_ms is None else slo_ms
        r = self.pool.add(prompt, max_new_tokens, domain, arrival_ms,
                          deadline_ms=arrival_ms + budget,
                          priority=priority)
        r.gamma = self.cfg.draft_len
        self.avail_ms[r.rid] = arrival_ms
        self.tracer.mark("arrival", r.rid, arrival_ms, priority=priority,
                         deadline_ms=r.deadline_ms,
                         max_new_tokens=max_new_tokens)
        return r

    def _next_cohort(self) -> int:
        """Engine-global cohort sequence number (trace/decision join
        key); monotone in host execution order, so deterministic."""
        c = self._cohort_seq
        self._cohort_seq += 1
        return c

    # ----------------------------------------------------------- admission
    def _shed(self, r: Request, now_ms: float):
        """Admission rejected `r`: account it and release any state it
        held. Only zero-token requests are ever shed (the pool asserts),
        so nothing half-committed can leak out."""
        self.pool.shed_request(r.rid, now_ms)
        self.stats.note_shed()
        self.tracer.mark("shed", r.rid, now_ms)
        # unconditional: a no-op for never-prefilled rids, and under the
        # async backend it also cleans a slot a still-queued burst
        # prefill may be about to admit (the drop serializes behind it)
        self.backend.drop_request(r.rid)
        self.entry_logits.pop(r.rid, None)
        self.avail_ms.pop(r.rid, None)
        self.router.drop(r.rid)
        if self.executor is not None:
            self.executor.note_dropped(r.rid)

    def _preempt(self, r: Request, now_ms: float = 0.0):
        """Evict a lower-priority request's slots (admission preemption).
        Its committed stream stays intact in the pool; re-admission goes
        through `_ensure_prefilled`, which re-prefills prompt+generated
        (paying that prefill on the verify stage) — the cheap slot
        evict/re-admit path."""
        self.backend.drop_request(r.rid)
        self.entry_logits.pop(r.rid, None)
        if self.executor is not None:
            self.executor.note_dropped(r.rid)
        r.n_preemptions += 1
        self.stats.note_preempt()
        self.tracer.mark("preempt", r.rid, now_ms,
                         n_generated=len(r.generated))

    def _apply_admission(self, cands: List[Request], now_ms: float,
                         observation: Optional[PipelineObservation],
                         inflight_rids=frozenset(),
                         pipe_empty: bool = False) -> List[Request]:
        """Run the admission layer over the cohort candidates. Requests
        in the in-flight verification cohort are auto-admitted (their
        commit is imminent — shedding or preempting them would
        half-commit a stream); everything else may be queued, shed, or
        trigger a priority preemption."""
        if self.admission is None:
            return cands
        auto = [r for r in cands if r.rid in inflight_rids]
        rest = [r for r in cands if r.rid not in inflight_rids]
        active = [r for r in self.pool.pending(float("inf"))
                  if r.rid in self.entry_logits
                  and r.rid not in inflight_rids]
        dec = self.admission.decide(
            rest, now_ms, observation=observation, active=active,
            n_protected=len(inflight_rids), pipe_empty=pipe_empty)
        for r in dec.shed:
            self._shed(r, now_ms)
        preempted = {r.rid for r in dec.preempt}
        for r in dec.preempt:
            self._preempt(r, now_ms)
        return auto + [r for r in dec.admit if r.rid not in preempted]

    def _ensure_prefilled(self, r: Request, now_ms: Optional[float] = None):
        if r.rid in self.entry_logits:
            return
        if r.n_preemptions > 0 and r.generated:
            # a preemption victim re-entering: its re-prefill is charged
            # by the caller; the lifecycle track records the re-admission
            self.tracer.mark(
                "readmit", r.rid,
                self.clock_ms if now_ms is None else now_ms)
        ctx = list(r.prompt) + r.generated
        res = self.backend.prefill_target({r.rid: ctx})
        self.entry_logits[r.rid] = res[r.rid][0]
        if self.strategy != "ar":
            # drafters stay one token behind the committed stream so the
            # draft loop's first decode(prev) feeds ctx[-1] exactly once
            # (an empty d_ctx — single-token prompt — admits a bare slot)
            lls = self.backend.prefill_drafters({r.rid: ctx[:-1]})[r.rid]
            if self.strategy == "cosine" and self.cfg.enable_routing:
                # content-based routing prior (paper §5 request analysis)
                self.router.set_prior(r.rid, lls)

    def _ensure_prefilled_batch(self, rs: List[Request],
                                now_of: Optional[Dict[int, float]] = None):
        """Burst admission (DESIGN.md §2.7): prefill several cold
        requests through one masked `slot_extend` write per model when
        `cfg.batched_prefill` is on; otherwise the per-request path in
        submission order (the seed's byte-identical behaviour). Timing
        is charged by the caller either way — this only batches the
        token computation."""
        rs = [r for r in rs if r.rid not in self.entry_logits]
        if not rs:
            return
        now_of = now_of or {}
        if not self.cfg.batched_prefill or len(rs) == 1:
            for r in rs:
                self._ensure_prefilled(r, now_ms=now_of.get(r.rid))
            return
        for r in rs:
            if r.n_preemptions > 0 and r.generated:
                self.tracer.mark("readmit", r.rid,
                                 now_of.get(r.rid, self.clock_ms))
        ctxs = {r.rid: list(r.prompt) + r.generated for r in rs}
        res = self.backend.prefill_target(ctxs, batched=True)
        for rid, (lg, _) in res.items():
            self.entry_logits[rid] = lg
        if self.strategy != "ar":
            d_ctx = {rid: c[:-1] for rid, c in ctxs.items()}
            lls = self.backend.prefill_drafters(d_ctx, batched=True)
            if self.strategy == "cosine" and self.cfg.enable_routing:
                for rid in ctxs:
                    self.router.set_prior(rid, lls[rid])

    # ------------------------------------------------------------ planning
    def _plan_cohort(self, cands: List[Request],
                     observation: Optional[PipelineObservation] = None,
                     extra_ctx: Optional[Dict[int, int]] = None,
                     now_ms: float = 0.0):
        """Pick (batch, gammas) for one iteration. cosine solves Eq. (8);
        the baselines batch FIFO with a fixed draft length."""
        if self.strategy == "cosine":
            plan = self.sched.plan(
                cands, pipelined=self.executor is not None,
                n_drafters=self.cfg.drafters_per_request,
                n_nodes=len(self.drafters),
                observation=observation, extra_ctx=extra_ctx,
                now_ms=now_ms)
            return plan.requests, plan.gammas
        batch = sorted(cands, key=lambda r: r.arrival_ms)[: self.cfg.max_batch]
        return batch, [self.cfg.draft_len] * len(batch)

    def _cohort_gammas(self, reqs: List[Request]) -> List[int]:
        """Draft lengths for a redraft cohort (no re-planning)."""
        if self.strategy == "cosine":
            return adaptive_speculation([r.gamma for r in reqs],
                                        self.cfg.gamma_max_total,
                                        self.cfg.min_gamma)
        return [self.cfg.draft_len] * len(reqs)

    # ------------------------------------------------------------ drafting
    def _participants(self, r: Request) -> List[int]:
        n = len(self.drafters)
        if self.strategy == "cosine":
            if not self.cfg.enable_routing:   # ablation: random assignment
                k = min(self.cfg.drafters_per_request, n)
                return sorted(self.rng.choice(n, size=k, replace=False).tolist())
            return self.router.route(r.rid, r.l_acc_ema)
        if self.strategy == "specinfer":
            return list(range(n))
        return [0]

    def draft_batch(self, parts: List[List[int]], b: int) -> int:
        """Drafting batch the analytic cost should charge: the most
        loaded node's routed sub-batch size (the lock-step pace setter),
        or the cohort width under the legacy full fan-out."""
        if not self.cfg.subbatch_drafting or not parts:
            return b
        counts: Dict[int, int] = {}
        for p in parts:
            for di in p:
                counts[di] = counts.get(di, 0) + 1
        return max(counts.values(), default=b)

    def n_active(self, entries: List[DraftEntry]) -> int:
        """Drafters concurrently active per request under `strategy`."""
        if self.strategy == "cosine":
            mean = sum(len(e.parts) for e in entries) / max(len(entries), 1)
            return max(int(np.ceil(mean)), 1)
        return len(self.drafters) if self.strategy == "specinfer" else 1

    def _build_entry_tree(self, chain_t, chain_p, d_toks, d_confs,
                          parts, g: int) -> tree_mod.TokenTree:
        """Tree for one request: fused main chain + per-drafter side
        branches (cosine), full specinfer tree, or a bare chain."""
        N = len(self.drafters)
        if self.strategy == "cosine" and self.tree_capable \
                and self.cfg.tree_width > 0:
            side_p = np.where(np.isin(np.arange(N), parts), d_confs.T, -1.0)
            side_d = np.broadcast_to(np.arange(N), (g, N))
            return tree_mod.build_tree(chain_t, chain_p, d_toks.T, side_p,
                                       side_d, self.cfg.tree_width)
        if self.strategy == "specinfer" and self.tree_capable:
            return tree_mod.build_tree(
                chain_t, chain_p, d_toks.T, d_confs.T,
                np.broadcast_to(np.arange(N), (g, N)),
                tree_width=max(N - 1, 1))
        return tree_mod.chain_tree(chain_t, chain_p)

    def _draft_entries(self, batch: List[Request], gammas: List[int],
                       optimistic: Optional[Dict[int, np.ndarray]] = None,
                       parts: Optional[List[List[int]]] = None,
                       roles: Optional[Dict[int, str]] = None
                       ) -> List[DraftEntry]:
        """Draft one cohort. `optimistic[rid]` is an (N, n) matrix of
        per-drafter chain tokens assumed to already extend rid's committed
        context (draft-ahead); requests are grouped by assumption width so
        teacher-forcing shapes stay exact (SSM-state safe).

        parts/roles: precomputed per-request participants and per-node
        cluster roles ("fused"/"side"/"dropped") from the drafter
        cluster's timing plan (DESIGN.md §2.4); None means every
        participant is on time (the coupled baselines)."""
        optimistic = optimistic or {}
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(batch):
            n = optimistic[r.rid].shape[1] if r.rid in optimistic else 0
            groups.setdefault(n, []).append(i)
        entries: List[Optional[DraftEntry]] = [None] * len(batch)
        for n, idxs in sorted(groups.items()):
            sub = [batch[i] for i in idxs]
            sub_g = [gammas[i] for i in idxs]
            sub_p = [parts[i] for i in idxs] if parts is not None else None
            teach = None
            if n:
                teach = np.stack([optimistic[r.rid] for r in sub], axis=1)
            for i, e in zip(idxs, self._draft_group(sub, sub_g, teach,
                                                    parts=sub_p,
                                                    roles=roles)):
                entries[i] = e
        return entries  # type: ignore[return-value]

    def _draft_group(self, batch: List[Request], gammas: List[int],
                     teach: Optional[np.ndarray] = None,
                     parts: Optional[List[List[int]]] = None,
                     roles: Optional[Dict[int, str]] = None
                     ) -> List[DraftEntry]:
        """Run the speculation cluster for one cohort (shared batch shape).

        Route-faithful sub-batching (DESIGN.md §2.4): each drafter node
        decodes only the requests routed to it. Per-node index maps
        (`rows_of[di]` = cohort positions, in cohort order) slice the slot
        snapshots, the teacher-forcing matrices and the K-step loop down
        to each node's sub-batch, so drafter compute scales with
        sum(|sub-batch|) ~= k*B — the timing `DrafterCluster.plan_cohort`
        already charges — instead of the SpecInfer-style N*B fan-out.
        Sub-batch shapes are bucketed by the runner (`slot_bucket`), so
        ragged per-node sizes stay within the bounded compile set. With
        `cfg.subbatch_drafting=False` (or specinfer, where every node is
        routed everything) every node decodes the whole cohort — the
        legacy full fan-out, kept token-identical (tested).

        teach: (N, B, n) per-drafter tokens to teacher-force into the slot
        snapshots before drafting (the optimistic context extension)."""
        B, K, N = len(batch), max(gammas), len(self.drafters)
        rids = [r.rid for r in batch]
        if parts is None:
            parts = [self._participants(r) for r in batch]
        roles = roles or {}
        # cluster roles (DESIGN.md §2.4): only on-time ("fused") nodes
        # take part in per-step confidence fusion; cut nodes run free on
        # their own chains. A request whose participants were all cut
        # falls back to fusing over them (degenerate local quorum).
        fuse_cand = [[i for i in p if roles.get(i, "fused") == "fused"] or p
                     for p in parts]
        # chains delivered to the server: everything not dropped
        delivered = [[i for i in p if roles.get(i, "fused") != "dropped"]
                     or fc for p, fc in zip(parts, fuse_cand)]
        fuse = self.strategy == "cosine" and self.cfg.enable_fusion

        # per-node index maps: rid -> sub-batch position is implied by
        # cohort order, so rows_of[di][j] is the cohort row of node di's
        # j-th sub-batch member
        if self.cfg.subbatch_drafting:
            active = sorted({i for p in parts for i in p})
            rows_of = {di: np.asarray([b for b in range(B) if di in parts[b]],
                                      np.int64) for di in active}
        else:
            active = list(range(N))
            rows_of = {di: np.arange(B, dtype=np.int64) for di in active}

        # slot-snapshot drafting: one device-side gather per node covering
        # only its routed rids; the snapshots are decoded on and then
        # discarded (= rollback) — the slot-resident caches only advance
        # at commit time.
        temp = {di: self.backend.draft_snapshot(
            di, [rids[b] for b in rows_of[di]]) for di in active}

        prev_last = np.array([(r.generated[-1] if r.generated
                               else int(r.prompt[-1])) for r in batch],
                             np.int32)
        prev_node: Dict[int, np.ndarray] = {}
        for di in active:
            rows = rows_of[di]
            if teach is None:
                prev_node[di] = prev_last[rows].copy()
            else:
                # drafter snapshots hold committed[:-1]; replay the last
                # committed token plus the assumed chain (minus its tail,
                # which becomes the next decode input) to reach the
                # optimistic state — sliced to this node's sub-batch
                t_rows = teach[di][rows]
                feed = np.concatenate([prev_last[rows][:, None],
                                       t_rows[:, :-1]], axis=1)
                temp[di] = self.backend.draft_extend(di, temp[di], feed)
                prev_node[di] = t_rows[:, -1].astype(np.int32).copy()

        # drafter-compute accounting: each node pays K steps over its own
        # sub-batch (the quantity the fig7 draft_calls column reports)
        for di in active:
            self.stats.note_draft_work(di, N, K * len(rows_of[di]))

        all_tokens = np.zeros((N, B, K), np.int32)
        all_confs = np.zeros((N, B, K), np.float32)
        d_chains = np.zeros((N, B, K), np.int32)
        chain_tokens = np.zeros((B, K), np.int32)
        chain_probs = np.zeros((B, K), np.float32)

        for i in range(K):
            step_tokens = np.zeros((N, B), np.int32)
            step_confs = np.full((N, B), -1.0, np.float32)
            for di in active:
                rows = rows_of[di]
                lg, temp[di] = self.backend.draft_decode(
                    di, [rids[b] for b in rows], prev_node[di], temp[di])
                probs = _softmax_f32(lg)
                tok = np.argmax(probs, -1)
                conf = np.take_along_axis(probs, tok[:, None], -1)[:, 0]
                step_tokens[di, rows] = tok
                step_confs[di, rows] = conf
            all_tokens[:, :, i] = step_tokens
            all_confs[:, :, i] = np.maximum(step_confs, 0.0)

            # confidence-based token fusion (Eq. 4), per request over only
            # that request's on-time participants
            fused = np.zeros(B, np.int32)
            fused_p = np.zeros(B, np.float32)
            for b in range(B):
                cand = fuse_cand[b]
                masked = np.full(N, -1.0)
                masked[cand] = step_confs[cand, b]
                best = int(np.argmax(masked))
                fused[b] = step_tokens[best, b]
                fused_p[b] = max(masked[best], 0.0)
            chain_tokens[:, i] = fused
            chain_probs[:, i] = fused_p

            for di in active:
                rows = rows_of[di]
                if fuse:
                    # cut nodes are out of the per-step sync: they chain
                    # on their own proposals, not the fused token
                    if roles.get(di, "fused") == "fused":
                        prev_node[di] = fused[rows].copy()
                    else:
                        prev_node[di] = step_tokens[di, rows].copy()
                elif self.strategy in ("specinfer", "cosine"):
                    # independent chains (SpecInfer; no-fusion ablation)
                    prev_node[di] = step_tokens[di, rows].copy()
                else:  # single-drafter chain
                    prev_node[di] = step_tokens[0, rows].copy()
                d_chains[di, rows, i] = prev_node[di]

        # (node, request) pairs outside the routed sub-batches consumed no
        # tokens; their teacher-forcing script is the fused chain — the
        # context extension the pending commit is assumed to add — which
        # is exactly what a fused-role node consumes under fusion, so a
        # node joining a request's participants next cohort warms up on
        # the assumed committed stream
        covered = np.zeros((N, B), bool)
        for di in active:
            covered[di, rows_of[di]] = True
        ni, bi = np.nonzero(~covered)
        d_chains[ni, bi, :] = chain_tokens[bi, :]

        out = []
        for b, r in enumerate(batch):
            g = gammas[b]
            # the token tree only carries chains that physically reached
            # the server (fused + in-grace side chains); dropped chains
            # contribute neither branches nor routing evidence
            tree = self._build_entry_tree(
                chain_tokens[b, :g], chain_probs[b, :g],
                all_tokens[:, b, :g], all_confs[:, b, :g], delivered[b], g)
            out.append(DraftEntry(
                req=r, gamma=g, tree=tree,
                fused_t=chain_tokens[b, :g].copy(),
                fused_p=chain_probs[b, :g].copy(),
                d_toks=all_tokens[:, b, :g].copy(),
                d_confs=all_confs[:, b, :g].copy(),
                d_chains=d_chains[:, b, :g].copy(),
                parts=delivered[b]))
        return out

    def _shift_entry(self, e: DraftEntry) -> Optional[DraftEntry]:
        """A surviving draft-ahead entry: its first fused token was just
        committed as the verifier's correction token, so the remaining
        chain is a valid draft on the new committed state."""
        g = e.gamma - 1
        if g < 1:
            return None
        tree = self._build_entry_tree(e.fused_t[1:], e.fused_p[1:],
                                      e.d_toks[:, 1:], e.d_confs[:, 1:],
                                      e.parts, g)
        return DraftEntry(req=e.req, gamma=g, tree=tree,
                          fused_t=e.fused_t[1:], fused_p=e.fused_p[1:],
                          d_toks=e.d_toks[:, 1:], d_confs=e.d_confs[:, 1:],
                          d_chains=e.d_chains[:, 1:], parts=e.parts)

    # ------------------------------------------------------------ verify
    def _verify_dispatch(self, entries: List[DraftEntry]) -> VerifyHandle:
        """Start the batched tree-verification forward for a cohort. On
        the simulated backend the forward runs synchronously here; on the
        async backend it is in flight on the verification server while
        the caller drafts ahead."""
        trees = [e.tree for e in entries]
        M_nodes = max(t.n_nodes for t in trees)
        padded = tree_mod.pad_trees(trees, M_nodes)
        rids = [e.req.rid for e in entries]
        return self.backend.verify_dispatch(rids, padded["tokens"],
                                            padded["rel_pos"],
                                            padded["mask"])

    def _resolve_tails(self) -> None:
        """Land the pending async commit's tail logits. Rids that left
        the engine since the commit was queued (completed, shed or
        preempted — their entry_logits entry was popped) are skipped so
        a stale tail can never resurrect a dropped request's state."""
        fut = self._tails_fut
        if fut is None:
            return
        self._tails_fut = None
        for rid, lg in fut.result().items():
            if rid in self.entry_logits:
                self.entry_logits[rid] = np.asarray(lg)

    def _verify_commit(self, entries: List[DraftEntry],
                       handle: Optional[VerifyHandle] = None):
        """Batched tree verification + commit: greedy acceptance walk,
        router update, cache extension (target exact, drafters one-behind)
        and tail entry logits. Returns (committed, total_committed).

        `handle` carries an already-dispatched verification (wall-clock
        pipelining); without one the forward is dispatched inline — the
        seed's synchronous call order."""
        batch = [e.req for e in entries]
        trees = [e.tree for e in entries]
        if handle is None:
            handle = self._verify_dispatch(entries)
        node_logits = handle.result()
        # previous commit's tail logits must land before the walk below
        # reads entry_logits (async backends defer the commit forward)
        self._resolve_tails()

        prev_last = {r.rid: (r.generated[-1] if r.generated
                             else int(r.prompt[-1])) for r in batch}
        committed: Dict[int, List[int]] = {}
        total_committed = 0
        for b, (e, r) in enumerate(zip(entries, batch)):
            t = trees[b]
            node_argmax = np.argmax(node_logits[b, : t.n_nodes], -1)
            entry_argmax = int(np.argmax(self.entry_logits[r.rid]))
            acc_tokens, acc_nodes, correction = tree_mod.accept_tree_greedy(
                t, node_argmax, entry_argmax)
            toks = acc_tokens + [int(correction)]
            remaining = r.max_new_tokens - len(r.generated)
            toks = toks[: max(remaining, 1)]
            if self.eos is not None and self.eos in toks:
                toks = toks[: toks.index(self.eos) + 1]
            committed[r.rid] = toks
            total_committed += len(toks)
            r.record_acceptance(len(toks), e.gamma)
            # routing update (Eq. 1-2) from this iteration's evidence
            if self.strategy == "cosine":
                self.router.update(r.rid, e.d_toks, e.d_confs, toks, e.parts)

        # ---- commit to target + drafters ----
        if self.backend.is_wallclock:
            # queue the commit forward on the verification server: it
            # overlaps the drafter commit + next draft on this thread,
            # and worker FIFO order guarantees it lands in the target
            # cache before the next verification reads the slots
            self._tails_fut = self.backend.commit_target_async(committed)
        else:
            tails = self.backend.commit_target(committed)
            for rid, lg in tails.items():
                self.entry_logits[rid] = lg
        if self.drafters:
            # one-behind invariant: drafters absorb the previously-held-back
            # token plus all but the last newly committed one
            d_committed = {rid: [prev_last[rid]] + toks[:-1]
                           for rid, toks in committed.items()}
            self.backend.commit_drafters(d_committed)
        return committed, total_committed

    # ------------------------------------------------------------ one step
    def step(self) -> Optional[IterationRecord]:
        """One serving iteration (delegates to the pipelined executor
        when the strategy decouples draft/verify); None when drained."""
        if self.executor is not None:
            return self.executor.step()

        pending = self.pool.pending(self.clock_ms)
        if not pending:
            future = [r.arrival_ms for r in self.pool.pending(float("inf"))]
            if not future:
                return None
            self.clock_ms = min(future)   # idle until next arrival
            pending = self.pool.pending(self.clock_ms)

        # admission (coupled path): the synchronous engine has no event
        # timeline, so saturation is proxied by the backlog exceeding
        # what one batch can hold
        if self.admission is not None:
            obs = PipelineObservation(
                queue_depth=1 if len(pending) > self.cfg.max_batch else 0,
                backlog=len(pending))
            pending = self._apply_admission(
                pending, self.clock_ms, obs,
                pipe_empty=not self.stats.records)
            if not pending:
                return self.step() if self.pool.pending(float("inf")) \
                    else None

        # cold requests pay their prompt forward on the same server the
        # pipelined strategies do (serialized prefill jobs) — TTFT is
        # apples-to-apples across all five strategies (ROADMAP item)
        cold = [r for r in pending if r.rid not in self.entry_logits]
        t_pf = sum(self.lat.t_prefill(r.context_len) for r in cold)
        self._ensure_prefilled_batch(pending)

        if self.strategy == "ar":
            return self._step_ar(pending, t_pf)
        return self._step_coupled(pending, t_pf)

    def _trace_coupled_record(self, rec: IterationRecord,
                              rids: Tuple[int, ...]):
        """Analytic-decomposition spans for the coupled baselines: the
        verifier provably idles through draft + communication, so the
        verify track tiles prefill → bubble(draft) → verify and the
        aggregate draft track carries one draft span — the same schema
        the pipelined strategies emit from their stage clocks, so the
        export works for all five strategies."""
        tr = self.tracer
        if not tr.enabled:
            return
        t0, c = rec.t_start_ms, rec.cohort
        if rec.prefill_ms > 0:
            tr.span("prefill", STAGE, VERIFY, t0, t0 + rec.prefill_ms,
                    cohort=c, rids=rids)
        if rec.draft_ms > 0:
            tr.span("draft", STAGE, DRAFT, rec.draft_start_ms,
                    rec.draft_start_ms + rec.draft_ms, cohort=c, rids=rids)
        if rec.verify_idle_ms > 0:
            tr.span("bubble", STAGE, VERIFY, t0 + rec.prefill_ms,
                    t0 + rec.prefill_ms + rec.verify_idle_ms,
                    cohort=c, rids=rids, cause="draft")
        tr.span("verify", STAGE, VERIFY, rec.verify_start_ms,
                rec.verify_start_ms + rec.verify_ms, cohort=c, rids=rids)

    def _step_coupled(self, pending: List[Request],
                      prefill_ms: float = 0.0) -> IterationRecord:
        batch, gammas = self._plan_cohort(pending, now_ms=self.clock_ms)
        parts = [self._participants(r) for r in batch]
        entries = self._draft_entries(batch, gammas, parts=parts)
        committed, total_committed = self._verify_commit(entries)

        b = len(batch)
        l = max(r.context_len for r in batch)
        gmax = max(gammas)
        big_gamma = sum(e.tree.n_nodes for e in entries)
        n_active = self.n_active(entries)
        # drafting cost is paid on the routed sub-batches: the lock-step
        # cluster advances at its most loaded node, not the cohort width
        b_draft = self.draft_batch(parts, b)
        t_ssm = self.lat.t_ssm(b_draft, l, gmax, n_active)
        t_llm = self.lat.t_llm(b, l, big_gamma)
        t_iter = self.lat.iteration_coupled(b, l, gmax, big_gamma, n_active,
                                            prefill_ms=prefill_ms,
                                            draft_b=b_draft)
        rec = IterationRecord(
            self.clock_ms, t_iter, b, big_gamma, total_committed, n_active,
            cohort=self._next_cohort(),
            draft_start_ms=self.clock_ms + prefill_ms, draft_ms=t_ssm,
            verify_start_ms=self.clock_ms + prefill_ms + t_ssm
            + self.lat.comm_ms,
            verify_ms=t_llm, prefill_ms=prefill_ms,
            # coupled execution: the verifier provably waits out the whole
            # draft + communication phase every iteration (prefill is
            # server *busy* time, not idle)
            verify_idle_ms=t_ssm + self.lat.comm_ms)
        self._trace_coupled_record(rec, tuple(r.rid for r in batch))
        self._finalize(batch, committed, rec)
        if self.strategy == "cosine":
            busy = t_llm / max(t_iter, 1e-9)
            for e in entries:
                if not e.req.done:
                    self.sched.update_gamma_feedback(
                        e.req, len(committed[e.req.rid]), busy,
                        now_ms=self.clock_ms)
        return rec

    def _step_ar(self, pending: List[Request],
                 prefill_ms: float = 0.0) -> IterationRecord:
        batch = sorted(pending, key=lambda r: r.arrival_ms)[: self.cfg.max_batch]
        committed: Dict[int, List[int]] = {}
        for r in batch:
            tok = int(np.argmax(self.entry_logits[r.rid]))
            committed[r.rid] = [tok]
        tails = self.backend.commit_target(committed)
        for rid, lg in tails.items():
            self.entry_logits[rid] = lg
        b = len(batch)
        l = max(r.context_len for r in batch)
        t_llm = self.lat.t_llm(b, l, b)
        rec = IterationRecord(self.clock_ms, t_llm + prefill_ms, b, b, b, 0,
                              cohort=self._next_cohort(),
                              verify_start_ms=self.clock_ms + prefill_ms,
                              verify_ms=t_llm, prefill_ms=prefill_ms)
        self._trace_coupled_record(rec, tuple(r.rid for r in batch))
        for r in batch:
            r.record_acceptance(1, 0)
        self._finalize(batch, committed, rec)
        return rec

    def _finalize(self, batch, committed, rec: IterationRecord):
        self.clock_ms = rec.t_start_ms + rec.t_iter_ms
        self.stats.add_record(rec)
        if self.admission is not None and rec.committed > 0:
            # measured service-time evidence for the shed test (ms/token
            # under the *current* load, not the analytic optimum)
            self.admission.svc.observe(rec.t_iter_ms, rec.committed,
                                       rec.batch, now_ms=self.clock_ms)
        for r in batch:
            toks = committed[r.rid]
            # commit instant at the iteration's end time — exactly
            # rec.t_start_ms + rec.t_iter_ms (tested against the record)
            self.tracer.mark("commit", r.rid, self.clock_ms,
                             cohort=rec.cohort, n_tokens=len(toks))
            if r.first_token_ms < 0 and toks:
                r.first_token_ms = self.clock_ms
                self.tracer.mark("first_token", r.rid, self.clock_ms,
                                 cohort=rec.cohort)
                self.metrics.observe(
                    "serve.ttft_ms", self.clock_ms - r.arrival_ms)
            r.generated.extend(toks)
            hit_eos = self.eos is not None and self.eos in toks
            if len(r.generated) >= r.max_new_tokens or hit_eos:
                self.pool.finish(r.rid, self.clock_ms)
                self.backend.drop_request(r.rid)
                self.entry_logits.pop(r.rid, None)
                self.avail_ms.pop(r.rid, None)
                self.router.drop(r.rid)
                self.tracer.mark("complete", r.rid, self.clock_ms,
                                 cohort=rec.cohort,
                                 n_generated=len(r.generated))
                self.metrics.inc("serve.completed")
                self.metrics.observe(
                    "serve.request_ms", self.clock_ms - r.arrival_ms)
            else:
                self.avail_ms[r.rid] = self.clock_ms
            if self.on_commit is not None and toks:
                # after completion handling, so a streaming consumer
                # that keys on req.done sees it set on the final commit
                self.on_commit(r, toks, self.clock_ms)

    def run(self, max_iterations: int = 10_000) -> ServeStats:
        """Step until the pool drains; returns the run's ServeStats. The
        steps run in the backend's `engine_stream` (on the wall-clock
        backend, the drafters' CUDA stream)."""
        with self.backend.engine_stream():
            for _ in range(max_iterations):
                if self.step() is None:
                    break
        return self.stats
