"""Device resolution shared by the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU; with
no CUDA available it raises rather than quietly running on the host.
TF32 is switched off for matrix products and cuDNN so float32 stays
float32, as it is in the JAX reference.
"""
from __future__ import annotations

import torch

#: NVIDIA H100 SXM5 80GB (data sheet), per card: HBM3 bandwidth, and the
#: dense peaks by operand type (f32 on the CUDA cores; bf16 and int8 on
#: the tensor cores, int8 in TOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises when CUDA is
    asked for but absent. On CUDA it switches TF32 off, so float32
    products stay float32 as in the reference. "meta" gives tensors
    with shapes and dtypes and no memory (the sharding rules and the
    dry-run read trees so)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name) -> torch.dtype:
    """ModelConfig.dtype string (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]
