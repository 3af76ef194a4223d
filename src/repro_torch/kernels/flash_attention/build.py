"""Build the flash-attention kernel at first use and load it with ctypes.

`nvcc` compiles `csrc/flash_attention.cu` for `sm_90a` into a shared
library with a plain C interface under `<repo>/build/kernels/` (listed
in `.gitignore`). The library's name carries a hash of the source and
the flags, so an edited source is rebuilt instead of a stale library
being loaded; the build writes to a temporary name and renames it, so
concurrent first uses cannot load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE.parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
#: compiler output of the build in this process (ptxas register and
#: shared-memory report), or None when the library was already built
build_log = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the flash-attention kernel is "
                           "built from source with the CUDA toolkit")
    return found


def library_path() -> Path:
    """Path of the built library for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflash_attention_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel unless the library for this source exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed to build the flash-attention "
                           f"kernel:\n{' '.join(cmd)}\n{res.stderr}")
    build_log = res.stdout + res.stderr
    os.replace(tmp, out)
    return out


def load():
    """The loaded library with its entry point's argument types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.fa_partial_launch
    fn.argtypes = ([vp] * 10            # q k v q_pos k_pos mask slot acc m l
                   + [i32] * 6          # B T G H S D
                   + [i64] * 14         # strides
                   + [ctypes.c_float]   # scale
                   + [i32] * 4          # causal window q_bf16 kv_bf16
                   + [vp])              # stream
    fn.restype = ctypes.c_int
    _lib = lib
    return lib
