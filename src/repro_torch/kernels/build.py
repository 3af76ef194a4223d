"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one `csrc/*.cu` source with a plain C entry point. `nvcc`
compiles it for `sm_90a` into a shared library under
`<repo>/build/kernels/` (listed in `.gitignore`). The library's name
carries a hash of the source, of the headers it includes and of the
flags, so an edited source is rebuilt instead of a stale library being
loaded; the build writes to a temporary name and renames it, so
concurrent first uses cannot load a half-written file.

`build_all` starts one `nvcc` per kernel at once and waits for all of
them, so a process that needs every kernel pays for the slowest build,
not for their sum. A lock per library makes its build and load happen
once when several threads call a wrapper first at the same time (the
async backend's server and engine threads), and `COUNT_LOCK` keeps the
wrappers' launch counters exact under such threads. `cuda_stream` is
the wrappers' launch stream (the calling thread's current stream).
`smem_report.cuh` (in `csrc/`) gives the tests each compiled kernel's
shared memory. `refuse_grad` is the wrappers' check that no launch
returns an output without a gradient one of its inputs asks for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
#: headers shared by several kernels' sources
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source with the CUDA toolkit")
    return found


#: the most shared memory (static and dynamic) one block may have on the
#: H100, its opt-in limit; the `gpu` tests hold it and every kernel's
#: size against the device
SMEM_LIMIT = 227 * 1024

#: held by every wrapper while it adds one to its `LAUNCHES` count: the
#: add is a read and a write, which two threads could interleave
COUNT_LOCK = threading.Lock()


def refuse_grad(kernel: str, missing: str, *tensors) -> None:
    """Raise where a kernel launch would return an output without the
    gradient an input asks for: under grad mode, when any of `tensors`
    (None allowed) requires a gradient. A ctypes launch writes into fresh
    outputs that autograd knows nothing of, so it never detaches them
    quietly; `missing` says which gradient there is not. (Every launch
    runs this: a plain loop over attribute reads, no generator.)"""
    import torch
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            raise RuntimeError(f"{kernel}: an input requires a gradient "
                               f"and {missing}")


def cuda_stream(dev) -> int:
    """The current CUDA stream of `dev` (a CUDA tensor's device, so its
    index is set) as an int, for a launch: the raw handle, with no Stream
    object built per call."""
    import torch
    return torch._C._cuda_getCurrentRawStream(dev.index)


class KernelLibrary:
    """One kernel source, its built library and its loaded entry point.

    `declare(lib)` sets the argument and result types of the library's C
    entry points once it is loaded."""

    def __init__(self, name: str, source: Path, headers=(), declare=None):
        self.name = name
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self._declare = declare
        self._lib = None
        # re-entrant: `build` starts the build it waits for
        self._lock = threading.RLock()
        self._proc = None
        self._tmp = None
        #: compiler output of the build in this process (ptxas register
        #: and shared-memory report), or None when it was already built
        self.build_log = None

    def library_path(self) -> Path:
        """Path of the built library for the current sources and flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for hdr in self.headers:
            h.update(hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def start_build(self) -> None:
        """Start `nvcc` in the background unless the library exists."""
        with self._lock:
            if self._proc is not None or self.library_path().exists():
                return
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            self._tmp = self.library_path().with_suffix(
                f".{os.getpid()}.tmp")
            self._cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp),
                         str(self.source)]
            self._proc = subprocess.Popen(self._cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)

    def build(self) -> Path:
        """Compile the kernel (or wait for the build `start_build` began)
        unless the library for this source exists."""
        with self._lock:
            out = self.library_path()
            if self._proc is None:
                if out.exists():
                    return out
                self.start_build()
            proc, self._proc = self._proc, None
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build the {self.name} "
                                   f"kernel:\n{' '.join(self._cmd)}\n{log}")
            self.build_log = log
            os.replace(self._tmp, out)
            return out

    def load(self):
        """The loaded library with its entry points' types declared."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(self.build()))
                    if self._declare is not None:
                        self._declare(lib)
                    self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Build every library in parallel (one `nvcc` each), then load."""
    for lib in libraries:
        lib.start_build()
    for lib in libraries:
        lib.load()
