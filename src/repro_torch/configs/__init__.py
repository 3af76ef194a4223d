"""Model configurations the port serves: the CoSine tiny pair, the
qwen1.5-4b target / qwen2-0.5b drafter pair, the SSM (mamba2-130m) and
hybrid (jamba-v0.1-52b) targets, the attention-MoE target
(qwen2-moe-a2.7b), qwen3-32b (qk-norm, GQA), the MLA + MoE target
deepseek-v3-671b, h2o-danube3-4b (SWA, head width 120), the
cross-attention VLM llama-3.2-vision-11b and the encoder-decoder
whisper-small: every architecture the reference registers; the
long-context policy of each and the (arch, input shape) pairs the
dry-run covers (`launch/dryrun.py`), as the reference's registry."""
from repro_torch.config import INPUT_SHAPES, ModelConfig
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.h2o_danube3_4b import CONFIG as H2O_DANUBE3_4B
from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from repro_torch.configs.llama_3_2_vision_11b import \
    CONFIG as LLAMA_3_2_VISION_11B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS = {c.name: c for c in (QWEN1_5_4B, QWEN2_0_5B, MAMBA2_130M,
                             JAMBA_V0_1_52B, QWEN2_MOE_A2_7B, QWEN3_32B,
                             DEEPSEEK_V3_671B, H2O_DANUBE3_4B,
                             LLAMA_3_2_VISION_11B, WHISPER_SMALL)}

# long_500k policy (DESIGN.md §5): how each arch gets sub-quadratic decode.
#   native  — already sub-quadratic (SSM / hybrid / native SWA)
#   swa     — run with the sliding-window KV variant (window 8192)
#   skip    — N/A by design (enc-dec whisper)
LONG_CONTEXT_POLICY: dict[str, str] = {
    "deepseek-v3-671b": "swa",
    "h2o-danube3-4b": "native",
    "qwen3-32b": "swa",
    "qwen1.5-4b": "swa",
    "whisper-small": "skip",
    "llama-3.2-vision-11b": "swa",
    "mamba2-130m": "native",
    "qwen2-moe-a2.7b": "swa",
    "qwen2-0.5b": "swa",
    "jamba-v0.1-52b": "native",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def arch_shape_pairs() -> list[tuple[str, str]]:
    """All (arch, shape) combos the dry-run must cover; skips excluded."""
    pairs = []
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            if shape == "long_500k" and LONG_CONTEXT_POLICY[arch] == "skip":
                continue
            pairs.append((arch, shape))
    return pairs
