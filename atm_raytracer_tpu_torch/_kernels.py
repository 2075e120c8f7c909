"""Build and bind the hand-written CUDA kernels in ``csrc/`` and the host
tile loaders in ``native/``.

Each ``.cu`` file is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, placed in
``_build/`` beside this file, and loaded with ``ctypes``. Each ``native/``
``.cpp`` file (the DTED and GeoTIFF loaders, host code) is compiled the
same way by ``g++``. A library's name carries a hash of the source and
of the headers it includes with quotes (``csrc/ray_device.cuh``), the
flags, the compiler's version and the host's architecture, so an edited
source or header rebuilds and a library built by another toolchain is
never loaded; a build writes a temporary file and renames it, so
processes that build at once never load half a library.

Every CUDA entry point takes device pointers and the CUDA stream as
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
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from atm_raytracer_tpu_torch/csrc at first use"
        )
    return found


@functools.lru_cache(maxsize=None)
def _compiler_id(compiler: str) -> str:
    """What ``compiler --version`` prints, and the host's machine."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed: {proc.stderr}")
    return f"{proc.stdout} {platform.machine()}"


LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _source_bytes(source: Path) -> list:
    """The bytes of ``source`` and of every file it includes with quotes
    (``#include "ray_device.cuh"``), theirs in turn, each once, in order."""
    seen, out, todo = set(), [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        out.append(data)
        todo += [(path.parent / m.decode()).resolve() for m in LOCAL_INCLUDE.findall(data)]
    return out


def _library_path(source: Path, flags, compiler: str) -> Path:
    """The library of ``source``: named by a hash of its bytes and its local
    headers', the flags, the compiler's version and the host's machine, so
    an edit of a shared header rebuilds every kernel that includes it."""
    key = b"\0".join([*_source_bytes(source), " ".join(flags).encode(),
                      _compiler_id(compiler).encode()])
    digest = hashlib.sha256(key).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def _compile(lib: Path, command) -> tuple:
    """Run ``command(out)``, which writes a library to ``out``, and move the
    result to ``lib`` atomically. Returns (seconds, the compiler's stderr);
    raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = command(str(tmp))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed for {lib.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    return seconds, proc.stderr


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
        return _library_path(CSRC / self.source, NVCC_FLAGS, _nvcc())

    def build(self) -> Path:
        """Compile the library unless a build of this exact source exists."""
        lib = self.library_path()
        if not lib.exists():
            self.build_seconds, self.build_log = _compile(
                lib, lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out, str(CSRC / self.source)])
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

# K3: the tilt-0 Rectilinear scan (generators/rectilinear.py::tilt0_hits),
# one launch per progress stride of coarse windows, state carried between;
# its exit and window-cull rules' inputs last
RECT_SCAN = CudaKernel(
    "rect_scan.cu", "rect_scan",
    [_P, _I, _I, _I, _F, _P, _I, _I, _I, _I, _I, _F, _P, _I, _P, _I, _F, _F, _I, _F, _F,
     _I, _F, _F, _P, _I, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P],
)

# K4: the capture scan of the tilted Rectilinear path
# (generators/rectilinear.py::culled_capture), one launch a round: each
# pixel's candidate blocks against the terrain envelope, their start states
# in M_CAND slots
RECT_CULLED = CudaKernel(
    "rect_culled.cu", "rect_culled",
    [_P, _I, _F, _I, _I, _I, _I, _I, _I, _I, _F, _P, _I, _P, _I, _F, _F, _I, _F, _F, _I,
     _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
)

# K6: the separable object pass (ops/objects.py::apply_objects_planes): its
# culling scan and window tables, the widened planes, then the pass, one
# launch a frame
OBJECT_PASS = CudaKernel(
    "object_pass.cu", "object_pass",
    [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F,
     _I, _P],
)

# K5: the exact test of the tilted Rectilinear path
# (generators/rectilinear.py::culled_test_round), one launch a round: each
# pixel without a hit walks its filled slots, re-integrating them against the
# terrain at its own azimuth, to its first crossing
RECT_EXACT = CudaKernel(
    "rect_exact.cu", "rect_exact",
    [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _I, _P, _I,
     _F, _F, _I, _F, _F, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P],
)

KERNELS = (COMBINE, MARCH, RECT_SCAN, RECT_CULLED, OBJECT_PASS, RECT_EXACT)


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the tile loaders are built from "
            "atm_raytracer_tpu_torch/native at first use"
        )
    return found


class HostLibrary:
    """One ``native/<source>`` C++ library for the host: built by g++ at
    first use (``libs``, the libraries it links, follow the source), loaded
    with ``ctypes``."""

    def __init__(self, source: str, libs=()):
        self.source = source
        self.libs = tuple(libs)
        self.build_seconds = None  # wall time of the g++ run, if one ran

    def library_path(self) -> Path:
        return _library_path(NATIVE / self.source, GXX_FLAGS + self.libs, _gxx())

    def build(self) -> Path:
        """Compile the library unless a build of this exact source exists."""
        lib = self.library_path()
        if not lib.exists():
            self.build_seconds, _ = _compile(lib, lambda out: [
                _gxx(), *GXX_FLAGS, "-o", out, str(NATIVE / self.source), *self.libs])
        return lib

    def load(self) -> ctypes.CDLL:
        return ctypes.CDLL(str(self.build()))


# the tile loaders (terrain/native.py); GeoTIFF inflates Deflate strips with zlib
DTED_LOADER = HostLibrary("dted_loader.cpp")
GEOTIFF_LOADER = HostLibrary("geotiff_loader.cpp", libs=("-lz",))
LOADERS = (DTED_LOADER, GEOTIFF_LOADER)
