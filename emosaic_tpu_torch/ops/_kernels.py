"""Build, load and launch the hand-written CUDA kernels under `csrc/`.

Each kernel is one `.cu` file with a plain C interface. It is compiled
with `nvcc` into a shared library in `emosaic_tpu_torch/_build/` (listed
in `.gitignore`) at first use, and loaded with `ctypes`. Nothing here
runs at import time: the CPU tests import every module, and a CPU host
has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One C entry point of a `csrc/<source>.cu` library (`source` defaults
    to `name`; kernels that share a source share its library).

    `launches` counts the calls that launched the kernel; the callers'
    wrappers are the only place that calls `launch`.
    """

    def __init__(self, name: str, symbol: str, argtypes: list, source: str | None = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source_name = source or name
        self.launches = 0
        self._fn = None
        self._err = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.source_name}.cu"

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"lib{self.source_name}.so"

    def build(self, force: bool = False) -> float:
        """Compile the library if it is missing or older than its source or
        a header under `csrc/`; returns the seconds spent compiling (0.0
        when up to date)."""
        lib = self.library
        newest = max(p.stat().st_mtime for p in (self.source, *CSRC.glob("*.cuh")))
        if not force and lib.exists() and lib.stat().st_mtime >= newest:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
        return time.perf_counter() - t0

    def _load(self):
        if self._fn is None:
            self.build()
            so = ctypes.CDLL(str(self.library))
            fn = getattr(so, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = so.emosaic_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (it enqueues on the given stream and
        returns `cudaGetLastError()`); raise on a non-zero code."""
        fn = self._load()
        code = fn(*args)
        if code != 0:
            msg = self._err(code).decode(errors="replace")
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({code})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

#: csrc/l1_argmin.cu (see ops/distance.py `l1_argmin`)
L1_ARGMIN = CudaKernel(
    "l1_argmin",
    "emosaic_l1_argmin",
    [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)
#: csrc/compose.cu (see ops/composite.py `compose_rows`)
COMPOSE = CudaKernel(
    "compose",
    "emosaic_compose",
    [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
)
#: csrc/l1_rows.cu (see ops/distance.py `l1_rows`)
L1_ROWS = CudaKernel(
    "l1_rows",
    "emosaic_l1_rows",
    [_I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_longlong, _I, _I, _I, _I, _P],
)
#: csrc/seg_topcap.cu (see ops/distance.py `seg_topcap`)
SEG_TOPCAP = CudaKernel(
    "seg_topcap",
    "emosaic_seg_topcap",
    [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_longlong, _I, ctypes.c_longlong,
     _I, _P],
)
#: csrc/floor_write.cu (see ops/composite_lab.py `floor_write`)
FLOOR_WRITE = CudaKernel(
    "floor_write",
    "emosaic_floor_write",
    [_I, _P, _P, ctypes.c_longlong, _P],
)
#: csrc/compose_bulk.cu, one stage (see ops/composite_lab.py `compose_rows_bulk`)
COMPOSE_BULK = CudaKernel(
    "compose_bulk",
    "emosaic_compose_bulk",
    [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
)
#: csrc/compose_bulk.cu, the two-stage ring (see ops/composite_lab.py
#: `compose_rows_bulk`)
COMPOSE_BULK2 = CudaKernel(
    "compose_bulk2",
    "emosaic_compose_bulk2",
    [_I, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
    source="compose_bulk",
)
#: csrc/band_transpose.cu (see ops/composite_lab.py `band_transpose`)
BAND_TRANSPOSE = CudaKernel(
    "band_transpose",
    "emosaic_band_transpose",
    [_I, _P, _P, _I, _I, _I, _I, _P],
)
_L = ctypes.c_longlong
#: csrc/coarse_topcap.cu (see ops/distance.py `coarse_topcap`)
COARSE_TOPCAP = CudaKernel(
    "coarse_topcap",
    "emosaic_coarse_topcap",
    [_I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _L, _I, _L, _I, _I, _I, _P],
)
#: csrc/l1_topcap.cu, the dense stripe (see ops/distance.py `l1_block`)
L1_STRIPE = CudaKernel(
    "l1_stripe",
    "emosaic_l1_stripe",
    [_I, _P, _P, _P, _L, _L, _I, _L, _L, _I, _I, _P],
    source="l1_topcap",
)
#: csrc/l1_topcap.cu, the fused per-segment top-cap (see ops/distance.py
#: `l1_topcap`)
L1_TOPCAP = CudaKernel(
    "l1_topcap",
    "emosaic_l1_topcap",
    [_I, _P, _P, _P, _L, _L, _I, _L, _L, _I, _I, _L, _L, _I, _I, _P],
)
KERNELS = (L1_ARGMIN, COMPOSE, L1_ROWS, SEG_TOPCAP, FLOOR_WRITE, COMPOSE_BULK,
           COMPOSE_BULK2, BAND_TRANSPOSE, COARSE_TOPCAP, L1_STRIPE, L1_TOPCAP)


def build_all(kernels=KERNELS, force: bool = False) -> dict:
    """Build the kernels' sources at once, one nvcc process per source;
    returns {source name: seconds}. Raises the first build error."""
    from concurrent.futures import ThreadPoolExecutor

    by_source = {k.source_name: k for k in kernels}
    with ThreadPoolExecutor(max_workers=len(by_source)) as ex:
        futs = {name: ex.submit(k.build, force) for name, k in by_source.items()}
        return {name: f.result() for name, f in futs.items()}
