"""Hardware latency/cost model (paper §4.3 "experimentally modeled"
T_ssm / T_llm, and Table 1 hardware constants).

This container is CPU-only, so the *scheduling* layer reasons about the
paper's deployment (consumer-GPU speculation cluster + datacenter-GPU
verification server) through this calibrated analytic model, while the
*token-level* computation is executed for real by the JAX models. The
model is linear in the quantities the paper identifies (batch size b,
critical length l, draft tokens gamma / verified tokens Gamma) and can be
refitted from measured samples via `fit()` (least squares).

Role split since the discrete-event executor (DESIGN.md §2/§3): this
model supplies *per-stage primitives only* — `t_ssm` (one drafting pass
on the cluster), `t_llm` (one verification forward on the server) and
`comm_ms` (cluster->server transfer). How those stages overlap is no
longer a formula: the executor (serving/pipeline.py) places them on
per-stage event clocks and measures the result. The closed-form
`iteration_coupled` remains the accounting for the coupled baselines
(ar/vanilla/specinfer), and `iteration_pipelined` survives only as the
scheduler's analytic planning estimate of a steady-state period — the
serving path never charges it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ---- Table 1 (paper) ----
HW = {
    "2080Ti": dict(flops=107.6e12, bw=616e9, ssm_tps=350.0, llm_tps=None,
                   rent=0.12, deploy=200),
    "3090": dict(flops=285e12, bw=936e9, ssm_tps=450.0, llm_tps=None,
                 rent=0.22, deploy=1000),
    "A100": dict(flops=5144e12 / 16, bw=2039e9, ssm_tps=9500.0, llm_tps=7.13,
                 rent=5.67, deploy=60000),
}


@dataclass(frozen=True)
class DrafterProfile:
    """Per-drafter-node latency personality (heterogeneous cluster).

    The paper's speculation side is a *cluster* of consumer-GPU nodes, so
    each drafter carries its own multiplier on the drafting step time, its
    own link delay to the verification server, and a deterministic, seeded
    jitter/straggler model (DESIGN.md §2.4):

      speed           — step-time multiplier (2.0 = a 2x slower node)
      comm_ms         — node->server transfer; None inherits the global
      jitter_frac     — lognormal sigma of per-job pace noise
      straggle_prob   — per-job probability of a straggle episode
      straggle_factor — pace multiplier during a straggle episode
    """
    speed: float = 1.0
    comm_ms: float | None = None
    jitter_frac: float = 0.0
    straggle_prob: float = 0.0
    straggle_factor: float = 4.0


def homogeneous_profiles(n: int) -> tuple:
    """Default cluster: n identical, jitter-free nodes (the seed's
    single-clock behaviour decomposed per node)."""
    return tuple(DrafterProfile() for _ in range(n))


# Default pace multiple of a weight-only-int8 drafter node (DESIGN.md
# §2.9): the drafter decode step is memory-roofline-bound on the weight
# stream (§3.2), and int8 halves it; activations, KV traffic and the
# host dispatch floor keep the realized step from a clean 0.5x — 0.6 is
# the analytic-roofline estimate (analysis/analytic.py weight-bytes
# term) and `calibrated_profiles()` recovers whatever pace the node
# actually sustains from its measured (b, l, step_ms) observations.
INT8_DRAFT_SPEED = 0.6


def pool_profiles(drafter_cfgs) -> tuple:
    """Per-node default profiles for a possibly mixed-precision pool:
    int8 weight-only nodes draft at `INT8_DRAFT_SPEED` x the bf16 step,
    everything else keeps the homogeneous default."""
    return tuple(
        DrafterProfile(speed=INT8_DRAFT_SPEED
                       if getattr(c, "quant", "") == "int8" else 1.0)
        for c in drafter_cfgs)


@dataclass
class LatencyModel:
    """T_ssm(b, l, gamma) and T_llm(b, l, Gamma) in milliseconds.

    T_ssm: sequential drafting — gamma autoregressive steps, each step
      memory-bound (weight streaming) with a mild context and batch term.
    T_llm: one parallel verification forward — base cost plus terms in the
      total verified tokens Gamma and KV/attention traffic b*l.
    """
    # drafter node (consumer GPU, e.g. 2080Ti): per-token step cost
    ssm_step_ms: float = 1000.0 / HW["2080Ti"]["ssm_tps"]   # ~2.86 ms/token
    ssm_ctx_ms_per_ktok: float = 0.08      # context-length term per step
    ssm_batch_ms: float = 0.12             # per extra request in the batch
    # verification server (4xA100, Table 1: 7.13 tok/s AR for the whole
    # server -> ~140 ms per forward); parallel verification of Gamma draft
    # tokens reuses the same weight pass (the paper's core premise), so the
    # per-token term is small
    llm_base_ms: float = 1000.0 / HW["A100"]["llm_tps"]      # ~140 ms/fwd
    llm_token_ms: float = 0.3              # per verified tree token
    llm_ctx_ms_per_ktok: float = 0.25      # per request-kilotoken of KV read
    # communication (10 Gbps, sub-1ms; token-level payloads)
    comm_ms: float = 0.8

    def t_ssm(self, b: int, l: int, gamma: int, n_drafters: int = 1) -> float:
        step = (self.ssm_step_ms + self.ssm_ctx_ms_per_ktok * l / 1000.0
                + self.ssm_batch_ms * max(b - 1, 0))
        # parallel drafters work concurrently; fusion syncs per step
        sync = 0.05 * max(n_drafters - 1, 0)
        return gamma * (step + sync)

    # ---- per-drafter-node primitives (heterogeneous cluster, §2.4) ----
    def ssm_step_node(self, b: int, l: int, profile: DrafterProfile,
                      pace_mult: float = 1.0) -> float:
        """One drafting step on one cluster node: the homogeneous step
        cost scaled by the node's speed and its (seeded) per-job pace
        multiplier. The fusion sync term is a *cluster* property (it
        depends on who the node syncs with), so it lives in
        serving/cluster.py, not here."""
        step = (self.ssm_step_ms + self.ssm_ctx_ms_per_ktok * l / 1000.0
                + self.ssm_batch_ms * max(b - 1, 0))
        return step * profile.speed * pace_mult

    def sync_ms(self, n_sync: int) -> float:
        """Per-step fusion synchronisation overhead for n_sync lock-step
        nodes (matches the homogeneous t_ssm's sync term)."""
        return 0.05 * max(n_sync - 1, 0)

    def node_comm_ms(self, profile: DrafterProfile) -> float:
        return self.comm_ms if profile.comm_ms is None else profile.comm_ms

    def t_llm(self, b: int, l: int, big_gamma: int) -> float:
        return (self.llm_base_ms + self.llm_token_ms * big_gamma
                + self.llm_ctx_ms_per_ktok * b * l / 1000.0)

    def t_prefill(self, l: int) -> float:
        """One prompt forward of l tokens on the verification server —
        same weight pass as verification, l tokens scored in parallel.
        The pipelined executor charges it as a verify-stage job so TTFT
        includes the cold-start prefill (DESIGN.md §2.2)."""
        return self.t_llm(1, l, l)

    def iteration_coupled(self, b, l, gamma, big_gamma, n_drafters=1,
                          prefill_ms: float = 0.0,
                          draft_b: int | None = None) -> float:
        """Sequential draft -> verify (vanilla/SpecInfer). `prefill_ms`
        is the serialized prompt-forward time for the iteration's cold
        requests — the coupled baselines pay TTFT on the same server the
        pipelined strategies do (no free prefills). `draft_b` is the
        drafting-side batch when it differs from the verified one (routed
        sub-batches: the most loaded node's share, not the cohort)."""
        return (prefill_ms
                + self.t_ssm(b if draft_b is None else draft_b, l, gamma,
                             n_drafters)
                + self.comm_ms + self.t_llm(b, l, big_gamma))

    def iteration_pipelined(self, b, l, gamma, big_gamma, n_drafters=1) -> float:
        """Analytic steady-state period of a perfectly overlapped pipeline:
        max(stages), the non-dominant stage hidden behind the dominant one.
        Planning estimate only (scheduler Eq. 8 / baseline comparisons) —
        execution-time overlap is measured by the event-driven executor,
        which also pays invalidation redrafts this formula ignores."""
        return max(self.t_ssm(b, l, gamma, n_drafters) + self.comm_ms,
                   self.t_llm(b, l, big_gamma))

    # ---- cost accounting (Table 3) ----
    def cost_per_ms(self, n_drafter_nodes: int, drafter_gpu="2080Ti",
                    n_server_gpus: int = 4) -> float:
        """$ per millisecond of wall time for the deployment."""
        hourly = (n_drafter_nodes * HW[drafter_gpu]["rent"]
                  + n_server_gpus * HW["A100"]["rent"])
        return hourly / 3600.0 / 1000.0

    # ---- calibration ----
    def fit_ssm(self, samples):
        """samples: list of (b, l, gamma, measured_ms). Least-squares refit."""
        A = np.array([[g, g * l / 1000.0, g * max(b - 1, 0)]
                      for b, l, g, _ in samples])
        y = np.array([t for *_, t in samples])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        self.ssm_step_ms, self.ssm_ctx_ms_per_ktok, self.ssm_batch_ms = map(
            float, np.maximum(coef, 1e-6))

    def fit_llm(self, samples):
        """samples: list of (b, l, Gamma, measured_ms)."""
        A = np.array([[1.0, g, b * l / 1000.0] for b, l, g, _ in samples])
        y = np.array([t for *_, t in samples])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        self.llm_base_ms, self.llm_token_ms, self.llm_ctx_ms_per_ktok = map(
            float, np.maximum(coef, 1e-6))
