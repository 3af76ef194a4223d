"""Drafter (SSM, "small speculative model") configs for the CoSine
speculation cluster.

The paper's drafters are LLaMA-68M / Qwen2.5-0.5B-class models fine-tuned
per domain (Table 2). `llama-68m` mirrors the LLaMA-68M drafter used with
the paper's LLaMA pair; `tiny-*` are CPU-trainable variants used by the
runnable examples and tests, where domain specialization is produced by
actually training each drafter on its own synthetic domain corpus.
"""
from repro_torch.config import ModelConfig

# weight-only int8 variant of the same drafter (DESIGN.md §2.9): the
# checkpoint is calibrated and swapped at load; beside bf16 nodes this
# makes the pool genuinely heterogeneous in both pace and proposals
def int8_variant(cfg: ModelConfig) -> ModelConfig:
    """Per-node override: run this drafter with int8 weights."""
    return cfg.with_overrides(quant="int8",
                              name=cfg.name + "-int8")


LLAMA_68M = ModelConfig(
    name="llama-68m",
    family="dense",
    n_layers=2,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=32000,
    rope_theta=10000.0,
)

LLAMA_68M_INT8 = int8_variant(LLAMA_68M)


def tiny_drafter(vocab: int, name: str = "tiny-drafter",
                 quant: str = "") -> ModelConfig:
    """CPU-trainable drafter in the same family as the target.

    `quant`: "" inherits the pool-wide `CoSineConfig.drafter_quant`
    default; "int8" pins this node to the weight-only int8 path.
    """
    return ModelConfig(
        name=name, family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384, vocab=vocab,
        tie_embeddings=True, quant=quant,
    )


def tiny_target(vocab: int, name: str = "tiny-target") -> ModelConfig:
    """CPU-runnable verification target (bigger than the drafters)."""
    return ModelConfig(
        name=name, family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=4, head_dim=32, d_ff=768, vocab=vocab,
        tie_embeddings=True,
    )
