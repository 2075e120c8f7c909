"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` file is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, placed in
``_build/`` beside this file, and loaded with ``ctypes``. The library name
carries a hash of the source and the flags, so an edited source rebuilds.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and ints as ``int``, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; ``CudaKernel.call``
raises when that is not 0. Nothing here falls back to another
implementation: a missing compiler or a failed build raises.

``--use_fast_math`` is deliberately absent (flushed denormals would break
the combine kernel's exact parity with the plain version), and
``-fmad=false`` keeps the march kernel's rounding that of the unfused
PyTorch ops it is compared with (its fine altitudes are bit-equal to the
PyTorch Hermite fill of its own nodes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from atm_raytracer_tpu_torch/csrc at first use"
        )
    return found


class CudaKernel:
    """One ``csrc/<source>`` library: lazy build, ctypes binding, and the
    count of kernel launches made through it (``launches``)."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds = None  # wall time of the nvcc run, if one ran
        self.build_log = ""  # ptxas register / shared-memory report
        self._fn = None

    def library_path(self) -> Path:
        src = (CSRC / self.source).read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{Path(self.source).stem}_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless a build of this exact source exists."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
        return lib

    def function(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._error_string = lib.error_string
            self._error_string.argtypes = [ctypes.c_int]
            self._error_string.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def call(self, device, *args) -> None:
        """Launch on ``device``'s current stream (passed after ``args``)
        with ``device`` made the current device: a launch onto a stream of
        another device than the current one fails, and PyTorch's own ops
        leave the current device as they found it. Raise on a refused
        launch."""
        import torch

        with torch.cuda.device(device):
            err = self.function()(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.entry} launch failed: cudaError {err} "
                f"({self._error_string(err).decode()})"
            )
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# K1: chunk envelopes + first-crossing segments (ops/combine.py), F frames in
# one call; one launch counted per call
COMBINE = CudaKernel(
    "combine.cu", "crossing_segments",
    [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
)
# K2: the fused march — RK4 nodes, Hermite fill, chord path lengths and their
# prefix sum, or the nodes alone (physics/ray.py); a table a frame by stride
MARCH = CudaKernel(
    "march.cu", "march_rays",
    [_P, _P, _I, _F, _I, _I, _I, _P, _I, _P, _I, _I, _I, _F, _F, _F, _F, _I, _F, _F,
     _P, _P, _P, _P, _P, _P, _I, _P],
)

KERNELS = (COMBINE, MARCH)
