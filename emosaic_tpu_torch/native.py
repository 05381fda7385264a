"""ctypes bindings for the C++ runtime helpers (csrc/emosaic_native.cpp).

A copy of `emosaic_tpu/native.py` for the port. The GPU owns every batched
kernel; the C++ side owns the inherently sequential no-repeat assignment
loops and the white-trim scan. `load()` builds the library with the host
C++ compiler (`$CXX`, default `g++`) into `emosaic_tpu_torch/_build/` at
first use, under a file lock, and rebuilds it when the source is newer.
Every entry point has a pure-Python fallback (render/greedy.py,
io/prep.py) for a host where the build fails.

One difference from the JAX package: an exception in a refill callback
is not served by the engine's host scan. The trampoline records it, the
engine stops, and `greedy_global` raises it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "emosaic_native.cpp"
BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libemosaic_native.so"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_lib = None
_load_attempted = False

#: C signature of the batched-refill callback (emosaic_native.cpp
#: emosaic_refill_cb): (user, block_ids*, m, used*, out_d*, out_r*) -> rc
_REFILL_CFUNC = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32),
)

#: the engines' stats slots (emosaic_native.cpp `Ctx::report`), in order,
#: as the keys `_engine_stats` writes; the counts among them
STATS = ("refill_host_events", "refill_host_s", "engine_entries", "engine_cb_events",
         "engine_cb_s", "engine_gather_s", "engine_requeues", "engine_loop_s")
_COUNTS = {"refill_host_events", "engine_entries", "engine_cb_events", "engine_requeues"}


def library_path() -> Path:
    return BUILD_DIR / _LIB_NAME


def build(force: bool = False) -> float:
    """Compile the library if it is missing or older than its source;
    returns the seconds spent (0.0 when up to date). Serialised with a
    file lock: parallel prep workers may all reach a missing library at
    once. Raises on a compiler error."""
    import fcntl
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        lib = library_path()
        if (
            not force
            and lib.exists()
            and lib.stat().st_mtime >= SOURCE.stat().st_mtime
        ):
            return 0.0
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}"
            )
        # a new inode: dlopen caches by (device, inode), so replacing the
        # file rather than rewriting it keeps a stale mapping out
        os.replace(tmp, lib)
        return time.perf_counter() - t0


def load() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        build()
        _lib = _bind(ctypes.CDLL(str(library_path())))
    except (OSError, RuntimeError, AttributeError, subprocess.SubprocessError):
        _lib = None
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    # the stats out-array: double[len(STATS)] or None
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.emosaic_greedy_sequence.argtypes = [
        i32p, i32p, i32p, i64, i64, u8p, u8p, i64, i64, i32p, i32p, f64p
    ]
    lib.emosaic_greedy_sequence.restype = ctypes.c_int
    lib.emosaic_greedy_global.argtypes = [
        i32p, i32p, i64, i64, u8p, u8p, i64, i64, i64, i32p, i32p, f64p
    ]
    lib.emosaic_greedy_global.restype = ctypes.c_int
    lib.emosaic_greedy_global_cb.argtypes = [
        i32p, i32p, i64, i64, u8p, u8p, i64, i64, i64,
        _REFILL_CFUNC, ctypes.c_void_p, i64, i64, i64, i32p, i32p, f64p
    ]
    lib.emosaic_greedy_global_cb.restype = ctypes.c_int
    lib.emosaic_greedy_global_keys.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        i64, i64, i64, u8p, u8p, i64, i64, i64, i32p, i32p, f64p
    ]
    lib.emosaic_greedy_global_keys.restype = ctypes.c_int
    lib.emosaic_trim_bounds.argtypes = [u8p, i64, i64, i32p]
    lib.emosaic_trim_bounds.restype = None
    return lib


def available() -> bool:
    return load() is not None


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def _engine_stats(out_stats, stats: dict | None) -> None:
    """The engine's stats slots into `stats` under the names of `STATS`,
    when given."""
    if stats is not None:
        stats.update({k: int(v) if k in _COUNTS else v for k, v in zip(STATS, out_stats)})


def greedy_sequence(
    order, cand_d, cand_r, blocks, lib, *, stats: dict | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Native in-render no-repeat assignment (see render/greedy.py).
    `stats`, when given, is filled as `greedy_global` fills it: the host
    masked scans (`refill_host_events`), their seconds (`refill_host_s`),
    the candidate entries read (`engine_entries`) and the engine's own
    seconds (`engine_loop_s`); it has no heap and no callback, so those
    counters read 0."""
    nl = load()
    b, k = cand_d.shape
    order = _c(order, np.int32)
    cand_d = _c(cand_d, np.int32)
    cand_r = _c(cand_r, np.int32)
    blocks = _c(blocks, np.uint8)
    lib = _c(lib, np.uint8)
    out_row = np.empty(b, dtype=np.int32)
    out_dist = np.empty(b, dtype=np.int32)
    out_stats = (ctypes.c_double * len(STATS))() if stats is not None else None
    rc = nl.emosaic_greedy_sequence(
        order, cand_d, cand_r, b, k, blocks, lib,
        lib.shape[0], lib.shape[1], out_row, out_dist, out_stats,
    )
    if rc != 0:
        raise RuntimeError(f"emosaic_greedy_sequence rc={rc}")
    _engine_stats(out_stats, stats)
    return out_row, out_dist


def greedy_global(
    cand_d,
    cand_r,
    blocks,
    lib,
    num_tiles,
    *,
    bits_c: int | None = None,
    refill_cb=None,
    cb_k: int | None = None,
    cb_margin: int = 8,
    cb_max_batch: int = 4096,
    stats: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Native global-greedy no-repeat assignment (see render/greedy.py).

    `refill_cb`, when given, replaces the engine's per-block host refill
    scans with batched device top-k calls: a Python callable
    (block_ids [M] int64, used uint8 [L]) -> (dists [M, cb_k] int32,
    rows [M, cb_k] int32), ascending (distance, row), I32_MAX-padded (see
    ops/refill.DeviceRefiller). Output is bit-identical with or without
    the callback. An exception in the callback stops the engine and is
    raised here. `stats`, when given, is filled from the engine's stats
    slots (`STATS`): its host masked scans (`refill_host_events`), their
    seconds (`refill_host_s`), and the candidate entries it read
    (`engine_entries`): each entry of the lists and of the refills counted
    once, when the engine moves past it, taken or skipped as used. At
    least one per assigned block; its mean per block is how deep the
    greedy goes into the lists. Then the refill callback's calls
    (`engine_cb_events`) and their seconds as the engine sees them, the
    crossing into Python included (`engine_cb_s`); the seconds of the
    engine's batching around each call, its scan of the blocks for nearly
    dry ones and its append of what came back (`engine_gather_s`); the
    heap's stale requeues (`engine_requeues`: a block popped at a key
    below its true next distance and pushed again at that distance); and
    the engine's own seconds, its whole call less the callbacks, gathers
    and host scans (`engine_loop_s`). The output is the
    same with or without `stats`.

    With `bits_c`, `cand_d` holds the card's sorted lists as they come to
    the host instead, u32 keys [B, K] (dist << bits_c) | row
    (`ops.distance.sorted_lists`), each decoded where the engine reads it,
    and `cand_r` is None: the output and `stats` of the pair they decode
    to. No refill callback then: u32 keys hold 255 * D * L < 2^32, so L * D
    is far under the device refill's threshold (`ops.refill.refiller_for`).
    """
    nl = load()
    b, k = cand_d.shape
    cand_d = _c(cand_d, np.int32 if bits_c is None else np.uint32)
    if bits_c is None:
        cand_r = _c(cand_r, np.int32)
    elif cand_r is not None or refill_cb is not None:
        raise ValueError("packed keys take neither a row array nor a refill callback")
    blocks = _c(blocks, np.uint8)
    lib = _c(lib, np.uint8)
    out_row = np.empty(b, dtype=np.int32)
    out_dist = np.empty(b, dtype=np.int32)
    out_stats = (ctypes.c_double * len(STATS))() if stats is not None else None
    if bits_c is not None:
        rc = nl.emosaic_greedy_global_keys(
            cand_d, b, k, bits_c, blocks, lib,
            lib.shape[0], lib.shape[1], num_tiles, out_row, out_dist, out_stats,
        )
    elif refill_cb is None:
        rc = nl.emosaic_greedy_global(
            cand_d, cand_r, b, k, blocks, lib,
            lib.shape[0], lib.shape[1], num_tiles, out_row, out_dist, out_stats,
        )
    else:
        L = lib.shape[0]
        if cb_k is None:
            # keep the engine's candidate width in lock-step with the
            # refiller's top-k width
            cb_k = getattr(refill_cb, "k", 256)
        failed = []

        def _trampoline(user, ids_ptr, m, used_ptr, out_d_ptr, out_r_ptr):
            try:
                ids = np.ctypeslib.as_array(ids_ptr, shape=(m,))
                used = np.ctypeslib.as_array(used_ptr, shape=(L,))
                d_, r_ = refill_cb(ids, used)
                np.ctypeslib.as_array(out_d_ptr, shape=(m, cb_k))[:] = d_
                np.ctypeslib.as_array(out_r_ptr, shape=(m, cb_k))[:] = r_
                return 0
            except Exception as e:
                failed.append(e)
                return -1  # stop the engine; raised below

        c_cb = _REFILL_CFUNC(_trampoline)  # keep alive for the call
        rc = nl.emosaic_greedy_global_cb(
            cand_d, cand_r, b, k, blocks, lib,
            lib.shape[0], lib.shape[1], num_tiles,
            c_cb, None, cb_k, cb_margin, cb_max_batch,
            out_row, out_dist, out_stats,
        )
        if failed:
            raise failed[0]
    if rc != 0:
        raise RuntimeError(f"emosaic_greedy_global rc={rc}")
    _engine_stats(out_stats, stats)
    return out_row, out_dist


def trim_bounds(img: np.ndarray) -> tuple[int, int, int, int]:
    """Native white-trim scan; raises ValueError like io/prep.trim_bounds."""
    nl = load()
    img = _c(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        # the C++ scan indexes (y*w+x)*3+2 unconditionally — a grayscale
        # or RGBA array would read past the buffer
        raise ValueError(f"trim_bounds needs [h, w, 3] u8, got {img.shape}")
    out = np.empty(4, dtype=np.int32)
    nl.emosaic_trim_bounds(img, img.shape[0], img.shape[1], out)
    if out[0] < 0:
        raise ValueError("image trims to nothing (all white?)")
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])
