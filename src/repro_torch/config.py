"""Model/system configuration for the repro framework.

One `ModelConfig` describes every assigned architecture family:
dense / MoE / MLA / SSM / hybrid / enc-dec (audio) / VLM cross-attention.
All configs are frozen dataclasses so they hash and can key jit caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

VOCAB_PAD_MULTIPLE = 256  # vocab padded so unembedding shards on any mesh axis


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (shared + routed, top-k)."""
    n_routed: int
    top_k: int
    d_ff: int                      # per-routed-expert hidden width
    n_shared: int = 0              # number of shared (always-on) experts
    shared_d_ff: int = 0           # total hidden width of shared experts (0 -> n_shared*d_ff)
    layer_offset: int = 0          # first layer index that is MoE
    layer_period: int = 1          # every `period`-th layer (from offset) is MoE
    router_aux_coef: float = 0.001  # load-balance aux loss coefficient

    def is_moe_layer(self, idx: int) -> bool:
        return idx >= self.layer_offset and (idx - self.layer_offset) % self.layer_period == 0

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff if self.shared_d_ff else self.n_shared * self.d_ff


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dimensions."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        # compressed KV latent + decoupled rope key, per token per layer
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention flavour
    attention: str = "full"        # full | swa | mla | none
    sliding_window: int = 0        # >0 with attention=="swa"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # block flavour
    norm_type: str = "rms"         # rms | layer
    mlp_type: str = "swiglu"       # swiglu | gelu
    pos_embed: str = "rope"        # rope | learned | none
    max_position: int = 0          # for learned pos embeds (0 -> unused)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): layer i is attention iff i % period == offset, else SSM
    hybrid_attn_period: int = 0
    hybrid_attn_offset: int = 0
    # vlm: layer i has cross-attention iff i % period == offset
    cross_attn_period: int = 0
    cross_attn_offset: int = 0
    n_frontend_tokens: int = 0     # stubbed modality tokens (audio frames / patches)
    frontend_dim: int = 0          # embedding dim supplied by the stub (0 -> d_model)
    # enc-dec (whisper): decoder config is `self`; encoder described here
    encoder_layers: int = 0
    encoder_seq: int = 0
    # extras
    tie_embeddings: bool = False
    mtp: bool = False              # DeepSeek multi-token-prediction head (depth 1)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # long-context variant: "none" (full attn as configured) | "swa" override
    long_context: str = "none"
    long_context_window: int = 8192
    # decode attention path: "scan" (sequential KV blocks — baseline) |
    # "parallel" (flash-decoding parallel partials; enables sequence-
    # parallel KV sharding — §Perf optimization)
    decode_attn: str = "scan"
    # KV cache dtype: "bf16" | "int8" (quantized serving caches — §Perf)
    kv_dtype: str = "bf16"
    # weight-only quantization (models/quantize.py, DESIGN.md §2.9):
    # "" (inherit the pool default, CoSineConfig.drafter_quant) | "none"
    # | "int8" (per-output-channel symmetric int8 dense/embed weights,
    # calibrated from the trained checkpoint and swapped at load).
    # Orthogonal to kv_dtype, which quantizes cache *activations*.
    quant: str = ""
    # KV block size for cached attention (0 -> 1024); with seq-parallel KV
    # set this to capacity / mesh_model so block boundaries = shard
    # boundaries (no resharding)
    decode_block: int = 0
    # MoE dispatch: "auto" (GSPMD decides — gathers expert weights when
    # tokens are data-sharded) | "gather_tokens" (constrain the token rows
    # replicated so each data shard runs its local experts over all tokens
    # and results reduce-scatter back — §Perf H2)
    moe_dispatch: str = "auto"

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return self.attention != "none" or self.hybrid_attn_period > 0

    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' mixer for layer idx."""
        if self.family == "ssm":
            return "ssm"
        if self.hybrid_attn_period:
            return "attn" if idx % self.hybrid_attn_period == self.hybrid_attn_offset else "ssm"
        return "attn"

    def is_cross_layer(self, idx: int) -> bool:
        if not self.cross_attn_period:
            return False
        return idx % self.cross_attn_period == self.cross_attn_offset

    def is_moe_layer(self, idx: int) -> bool:
        return self.moe is not None and self.moe.is_moe_layer(idx)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests.

        <=2 scan blocks, d_model<=256, <=4 routed experts, small vocab.
        Structural features (MoE/MLA/SSM/hybrid/cross/enc-dec) preserved.
        """
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        head_dim = 64
        kw = dict(
            name=self.name + "-smoke",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            max_position=min(self.max_position, 512) if self.max_position else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16) if self.n_frontend_tokens else 0,
            frontend_dim=0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
        )
        # keep the layer-pattern period intact; use 2 pattern blocks
        period = 1
        if self.hybrid_attn_period:
            period = max(period, self.hybrid_attn_period)
        if self.cross_attn_period:
            period = max(period, self.cross_attn_period)
        if self.moe is not None:
            period = max(period, self.moe.layer_period)
        n_layers = max(2, 2 * period)
        if self.moe is not None and self.moe.layer_offset:
            n_layers = max(n_layers, self.moe.layer_offset + 2 * self.moe.layer_period)
        kw["n_layers"] = n_layers
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_routed=min(self.moe.n_routed, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff=min(self.moe.d_ff, 256),
                n_shared=min(self.moe.n_shared, 1),
                shared_d_ff=min(self.moe.shared_d_ff, 256) if self.moe.shared_d_ff else 0,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=64,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=32, head_dim=32, chunk_size=16)
        return self.with_overrides(**kw)


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------- speculative-inference system config ----------------

@dataclass(frozen=True)
class CoSineConfig:
    """CoSine system knobs (paper §4)."""
    n_drafters: int = 4
    draft_len: int = 5             # gamma: draft tokens per iteration
    drafters_per_request: int = 2  # paper: 2-3 drafters selected per request
    tree_width: int = 2            # branches retained when building the token tree
    # routing (Eq. 3)
    tau: float = 2.0               # acceptance-length threshold for exploration
    alpha: float = 0.5             # exploration coefficient (alpha > beta)
    beta: float = 0.9              # exploitation coefficient
    routing_ema: float = 0.8       # EMA over historical routing scores
    # scheduler (Eq. 5-8)
    gamma_max_total: int = 64      # Gamma_max: verified-token budget per batch
    t_max_ms: float = 1e9          # latency SLO
    m_max_bytes: float = 1e15      # memory budget
    lam: float = 0.0015            # lambda: latency/throughput trade-off weight
    max_batch: int = 16
    # adaptive speculation (Alg. 2)
    min_gamma: int = 1
    gamma_max: int = 16            # hard per-request draft-length ceiling
    #                                (balance_gamma / feedback growth cap)
    # lambda feedback conditioning (scheduler.effective_lam): the
    # observation multipliers (queue pressure, starved verifier, hot
    # drafter) compose multiplicatively; the composed multiplier is
    # clamped to [lam_mult_min, lam_mult_max] so feedback can never
    # drive the effective lambda to extremes, and a deadband around the
    # busy-fraction thresholds keeps it from oscillating when a stage
    # hovers at its setpoint
    lam_mult_min: float = 0.25
    lam_mult_max: float = 8.0
    lam_deadband: float = 0.05
    # backlog aging (starvation freedom): each ms a request has waited
    # shrinks its effective context length by this many tokens in the
    # scheduler's sort key, so long-context requests age past the
    # candidate bound instead of starving behind a stream of short ones
    age_tok_per_ms: float = 0.05
    # priority classes: smaller is more urgent (0 = high, 1 = normal,
    # 2 = low); a class step is worth this much queue age in the sort key
    priority_age_bonus_ms: float = 2000.0
    # --- SLO-aware admission control (DESIGN.md §2.5) ---
    enable_admission: bool = False
    default_slo_ms: float = float("inf")  # per-request deadline budget
    #                                       (deadline = arrival + slo)
    admit_queue_cap: int = 0       # >0: max cold backlog under saturation
    #                                before the overflow is shed
    shed_when_late: bool = True    # shed queued zero-token requests that
    #                                can no longer meet their deadline
    #                                (only while the verifier saturates)
    preempt_priority: bool = True  # urgent arrivals evict the slots of
    #                                lower-priority in-flight requests
    #                                (slot evict / re-admit path)
    slo_trim: bool = True          # SpecServe-style per-request gamma
    #                                trimming when SLO headroom shrinks
    # multi-node drafter cluster (DESIGN.md §2.4)
    cut_pace_slack: float = 1.6    # fused lock-step window vs fastest node
    straggler_grace_frac: float = 0.25  # grace (frac of fused draft time)
    #                                     for late chains to join as side
    #                                     branches before being dropped
    conf_gate: float = 0.65        # fused confidence below which dispatch
    #                                waits the grace window for side chains
    straggler_policy: str = "side"  # "side" (late chains -> tree side
    #                                 branches) | "drop" (discard)
    straggler_penalty: float = 0.5  # router down-weight on chronically
    #                                 late nodes (Eq. 3 exploration)
    # route-faithful drafting (DESIGN.md §2.4): each drafter decodes only
    # the requests routed to it (its sub-batch), so drafter compute scales
    # with sum(|sub-batch|) ~= k*B rather than N*B. False restores the
    # legacy full fan-out (every node decodes the whole cohort) — kept for
    # the token-equivalence tests and as an explicit SpecInfer-style
    # ablation of the routing's compute saving.
    subbatch_drafting: bool = True
    # burst admission (DESIGN.md §2.7): batch several cold requests'
    # prompt forwards into one masked slot_extend write per model. Off
    # by default to keep the per-request prefill call order
    # byte-identical to the seed; the async backend always bursts (its
    # prefill queue naturally coalesces cold arrivals).
    batched_prefill: bool = False
    # ablation switches (paper §6.4)
    enable_routing: bool = True    # False -> random drafter selection
    enable_fusion: bool = True     # False -> independent per-drafter chains
    # observability (DESIGN.md §2.6), on by default: span tracing on the
    # simulated clocks; on the wall-clock backend also wall spans of its
    # two threads (a few us each) and the host-read counters
    # (`host.syncs`, `host.d2h_bytes`). obs_max_events > 0 ring-bounds
    # both the EventLog and the Tracer for long runs (oldest entries
    # drop; drop counts are surfaced in the metrics export)
    enable_tracing: bool = True
    obs_max_events: int = 0
    # --- paged KV/SSM pool (DESIGN.md §2.8) ---
    # paged_pool=True swaps the reserved-capacity slot cache (one
    # `bucket x max_len` row per resident request) for a fixed-size page
    # pool + per-request block tables: attention/MLA KV is allocated in
    # `page_size`-token pages on demand, reads gather only the pages a
    # request actually holds, and admission/eviction/rollback become
    # block-table operations. SSM state stays slot-indexed (it is O(1)
    # per request already). False (default) keeps the resident path
    # byte-identical to the path before paging.
    paged_pool: bool = False
    page_size: int = 64            # tokens per KV page (must divide the
    #                                ring capacity of windowed layers)
    pool_pages: int = 0            # pages pre-allocated per model pool
    #                                (0 -> small auto size; the pool grows
    #                                by doubling when the free list empties)
    # --- weight-only drafter quantization (DESIGN.md §2.9) ---
    # pool-wide default for drafters whose ModelConfig.quant is ""
    # (unset): "none" keeps f32/bf16 weights, "int8" calibrates and
    # swaps per-output-channel int8 weights at engine construction.
    # A per-drafter ModelConfig.quant overrides this, so one pool can
    # run an int8 node beside bf16 nodes (configs/drafters.py).
    # Committed streams stay greedy-exact either way: only drafter
    # proposals change, never the target's accept/correct walk.
    drafter_quant: str = "none"
