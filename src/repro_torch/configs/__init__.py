"""Model configurations the port serves: the CoSine tiny pair and the
qwen1.5-4b target / qwen2-0.5b drafter pair."""
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B

ARCHS = {c.name: c for c in (QWEN1_5_4B, QWEN2_0_5B)}
