#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`emosaic_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

  A  environment: torch/CUDA versions, the card's name and power limit,
     nvcc, and a GPU, or it stops;
  B  build: the fifteen CUDA kernels from the twelve sources of
     `emosaic_tpu_torch/csrc/` (one nvcc per source, started together) and
     the native C++ greedy engine;
  C  each kernel against its plain torch version on the card, exactly:
     K1 (L1 argmin), K2 (composite), K3 (shortlist rescore), K4
     (segment top-cap, caps 1 to 128) and K9 (the fused coarse pass: keys
     and s_min at nseg 1..1563, caps 1, 8, 16, every dout the plan gives,
     6..1536, on clustered and duplicated data; timed at the flagship
     shape against cdist + K4, with the FP32 lanes' rate, derived and
     measured, as its ceiling) and K10 (the exact u8 L1 kernel: its stripe
     entry at D 3..49152, its fused per-segment top-cap at caps 1..33 on
     tie storms, a padded last segment, col0 offsets and rows past 2^24,
     both at the worst case's and P4's shapes; the stripe timed against
     `torch.cdist(p=1)`, the top-cap against cdist + the per-segment
     selection it replaces) and K11 (the exact squared-L2 kernel on the
     tensor cores: its argmin and its per-segment top-cap at phase H's
     mode-4 shape and the flagship chunk, sampled, at D 12..49152 with
     the split depth, every segment length, caps 1..32, tie storms and
     col0 / real_l padding; timed against the f32 `torch.matmul` score
     stripes and the argmin or packed-key `torch.topk` they replace) and
     K12 (the no-repeat engine's masked refill: at the `generate_m32`
     refill's shape at M 1, 4 and past the crossover, ragged libraries,
     rows of 24..4112 bytes, masks with none, half and all rows used, k
     1..256; timed at M 1, 4, 64, the crossover and twice it against the
     gather + K10 stripe + `torch.topk` chain it replaces, with the
     crossover that run measures) and K13 (the exact-full route's per-row
     sort: at the `service_m16` cell's matrix, the route's longest rows
     (u64 keys, chunks merged through device memory), odd row lengths,
     one-entry rows, tie storms and keys of 32 and 33 bits
     (`probes/k13.py`); timed at the cell's shape and at the longest rows
     against its bound and `torch.sort` of the same keys, with the host
     sort it replaces) at
     test and main-path shapes, K3 and K4
     also past 4 GiB; K1 also on tie storms, at D = 49152 and 65800 and across D
     (12..3072 at B=4096, L=200000, in T byte pairs/s), K3 on both of its
     paths with ragged groups; the CUDA cores' VABSDIFF4 rate, derived and
     measured, and its share of K1's code (`cuobjdump -sass`); the
     composite lab kernels K5 (write floor), K6 and K7 (the
     band through bulk copies, one stage and a two-stage ring) and K8
     (relayout of gathered tiles) at ts 8..64 and nbx 77..4096 with edge
     items, at the BASELINE band and past 4 GiB (K5's band; K6 and K7 on a
     9.8 GB stack); the tint over all 256 alphas x 65536 pairs, the card's
     LUT against the CPU's, and a no-fallback run with the plain versions
     made to raise (and `torch.cdist` on K10's routes; phase H runs with
     K11's plain versions raising too);
  D  the repeat main path at the BASELINE size through `render_nto1`,
     from in-memory arrays: 100k synthetic tiles, mode 1 on a 4096^2
     source (LUT), then mode 4 on a 2048^2 source (K1) streamed with a
     0.3 tint into a PNG;
  N  the no-repeat main path at the flagship size through
     `render_nto1_no_repeat`: 32767 clustered synthetic tiles, mode 32 on
     a 4096^2 source (the adaptive scorer: K9 in its coarse pass, K3 in
     its rescore; the native greedy engine with device refills; K2), its
     candidate lists against the two-level scorer's, K3 timed on those
     lists' own rescore inputs with their reuse, the worst case
     (uniform data) through `l1_topk` (the two-level scorer on K10, with
     its own launch counts), a full-library-consumption
     assignment with device refills (K12 up to the crossover, K10's
     stripe above it) against host scans, and the same scene rendered
     through `render_nto1_no_repeat` with a flat band of 1024 blocks
     (their lists run dry together: refill calls of one block and of
     hundreds), against the same render on the engine's host scans;
  L  the lab probes, with the composite lab kernels' plain versions made
     to raise: `probes/seg8.py` (`seg_topk` on K4, and the coarse pass at
     the TPU tool's 200k shape on K9 and on the cdist stripe + K4, both
     bit-equal to the plain selection, with times), `probes/flatdma.py`
     (peak device bytes of K3, the coarse pass (K9, no stripe), the
     rescore and the whole scorer at a 2M-row library; fails on a
     library-sized temporary), `probes/r3_composite.py` (C0..C10: K2, K5,
     K6 and K7 at the r3 tools' band, each bit-equal to K2) and
     `probes/composite_variants.py` (v1, v4, v3d = K8, K2 at a 1.61 GB
     band, each equal to v1, and the match-phase breakdown);
  H  this slice's paths at full width: `render_nto1` with `hybrid=True`
     and with `metric="l2"` at phase D's mode-4 shape (K11's top-cap and
     argmin, K3), the hybrid no-repeat scorer at phase N's flagship shape
     (K11's top-cap, K3), and random mode
     into an 8192^2 output, in memory and through the streamed composite
     (K2);
  E  the CLI, `python -m emosaic_tpu_torch.cli ... --device cuda`, on a
     generated 4000x3000 photo and 4096 tile files (needs Pillow): modes
     1 and 4, then `--no-repeat`, `--no-repeat --greedy` and
     `--randomize 10` at mode 16, `--matcher hybrid` and `--metric l2` at
     mode 4, `--html --web` at mode 1 (the pages, and the assets equal to
     the package's), `--profile` at mode 4 (the Chrome trace names K1's
     and K2's kernels; the PNG equals the run without it), and `-m random`
     on a 256x192 photo;
  S  the resident service (`emosaic_tpu_torch.serve`) on E's scene: a
     `MosaicService` at `-m 4 -s 32` behind its HTTP handler in this
     process, warmed up, takes buffered, tinted and streamed (chunked)
     requests, a first and 5 warm of each, `/healthz` while a render is in
     flight, and a stalled streaming client (the card's memory must come
     back and the next request render); a `-m 16` service takes
     `no_repeat=1` and `no_repeat=1&greedy=1`; each class's warm request
     is replayed step by step for its split, and its PNG must equal the
     replay's (the buffered one `render_nto1` + a PNG encode, the chunked
     body the buffered image); then `python -m emosaic_tpu_torch.serve
     ... --warmup 1000x750` as a subprocess answers `/healthz` and a
     request;
  P  `parallel/` on virtual meshes of the one card (eight positions on
     cuda:0), each sharded route byte-equal to the single-device route on
     the same inputs, with both times: P1 `sharded_l1_argmin` (4x2) and
     P2 `sharded_l1_argmin_ring` (n = 8) at phase D's mode-4 shape with
     planted cross-shard ties, P3 `sharded_l1_topk_adaptive` (1x8) at the
     flagship no-repeat shape (every row certified, the adaptive route), P4
     `sharded_l1_topk` (4x2, D = 48), P5 `sharded_build_l1_lut` (n = 8)
     from phase D's mode-1 library, P6 `sharded_mosaic_step` (4x2) on phase
     D's mode-4 scene against `render_nto1`'s image, P7 `render_nto1(mesh=)`
     at mode 4 and `render_nto1_no_repeat(mesh=)` at the flagship (their
     item grids); P8 the CLI on two processes sharing cuda:0
     (EMOSAIC_DISTRIBUTED, `--mesh 2`, host-staged gloo) at `-m 4` and
     `-m 16 --no-repeat` on phase E's scene, rank 0's PNG equal to a
     single-process run's and rank 1 standing down; P9 an NCCL world of
     one process carrying `sharded_l1_argmin`'s exchange. A virtual mesh
     measures the shard plumbing's overhead, not a multi-GPU speedup;
  F  the launch counts of each main path's run (D: K1 and K2; N: K3, K9
     and K2, in its worst case K10's two entries, in its full
     consumption and its refilling render K12; H: K3, K2 and K11's
     two entries; L: K4,
     K9, K5, K6, K7 and K8; S: K1, K2, K10's stripe and K13; P: K1, K2, K3, K9
     and K10's top-cap), which must be > 0.

Phases run in the order A, B, C, D, N, L, H, E, S, P (P's CLI runs reuse
E's scene and caches), then F. Any failed check raises, so the exit code
is non-zero and no result line is printed. The last lines are one JSON object listing every kernel (with
its launches, error, times and bound), the card's name and power limit,
and `{"ok": true, "device": {...}}`.

Bounds (`bound_ms`): the larger of the bytes the function must move (each
input read once, each output written once; for gathers, the rows this
run's indices reach) over 3.35 TB/s, and its integer operations (an
absolute difference and an add per byte pair, for K11 a multiply and an
add; none counted for a selection) over 1979 TOP/s, the H100 SXM's
published HBM rate and int8
peak at its 700 W limit; for K13, the matrix read once and its sorted
lists written once. K1, K3, K9, K10 and K12 also carry `ceiling_ms`: exact L1
has no tensor-core form at a useful cost, so the least time their
CUDA-core work can take is the byte pairs over the VABSDIFF4 rate (SMs x
64 lanes x 4 byte pairs x the maximum SM clock, or what a pure VABSDIFF4
kernel reaches on the card, whichever is larger), for K9 the coordinate
pairs over the FP32 lanes' rate (two FADDs a pair: SMs x 64 x the
clock, or a pure FADD kernel's rate), or the bytes over the HBM rate if
that is longer (`ceiling_by` states the derivation).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"  # listed in .gitignore; removed at the end
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8, published


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT8_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def vsad_rate(torch, dev, card) -> dict:
    """The CUDA cores' rate of byte absolute differences, the limit K1 and
    K3 can reach (exact L1 on u8 has no tensor-core form at a useful cost):
    derived as SMs x 64 VABSDIFF4 lanes per clock x 4 byte pairs x the
    card's maximum SM clock, and measured with the pure VABSDIFF4 kernel
    of `csrc/l1_argmin.cu` (8 independent chains a thread, 8 blocks of 256
    threads per SM). The ceiling uses the larger of the two."""
    import ctypes

    from emosaic_tpu_torch.ops._kernels import L1_ARGMIN

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    derived = sms * 64 * 4 * mhz * 1e6
    fn = ctypes.CDLL(str(L1_ARGMIN.library)).emosaic_vsad_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks, iters = sms * 8, 2048

    def run():
        check(fn(dev.index, out.data_ptr(), blocks, iters, stream) == 0, "vsad_rate launch")

    ms = cuda_ms(torch, run, reps=3)
    measured = blocks * 256 * 8 * 16 * iters * 4 / (ms * 1e-3)
    log(f"VABSDIFF4 rate: derived {sms} SMs x 64 lanes x 4 byte pairs x {mhz:.0f} MHz = "
        f"{derived / 1e12:.2f} T byte pairs/s; a pure VABSDIFF4 kernel reached "
        f"{measured / 1e12:.2f} [{card}]")
    return {"rate": max(derived, measured), "derived": derived, "measured": measured,
            "how": f"{sms} SMs x 64 VABSDIFF4 lanes x 4 byte pairs x {mhz:.0f} MHz = "
                   f"{derived / 1e12:.2f} T byte pairs/s; a pure VABSDIFF4 kernel "
                   f"measured {measured / 1e12:.2f}; the larger"}


def fadd_rate(torch, dev, card) -> dict:
    """The FP32 lanes' rate of K9's inner step, a (row, position,
    coordinate) pair = an FADD of the difference and an FADD of its |.|
    into the sum: derived as SMs x 128 lanes / 2 FADDs x the card's maximum
    SM clock, and measured with the pure FADD / FADD.abs kernel of
    `csrc/coarse_topcap.cu` (16 chains a thread, 8 blocks of 256 threads per
    SM). K9's ceiling uses the larger of the two."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    derived = sms * 64 * mhz * 1e6
    measured = probe_rate(torch, dev, "emosaic_fadd_rate", 1)
    log(f"FP32 rate: derived {sms} SMs x 128 lanes / 2 FADDs x {mhz:.0f} MHz = "
        f"{derived / 1e12:.2f} T pairs/s; a pure FADD/FADD.abs kernel reached "
        f"{measured / 1e12:.2f} [{card}]")
    return {"rate": max(derived, measured), "derived": derived, "measured": measured,
            "how": f"{sms} SMs x 128 FP32 lanes / 2 FADDs x {mhz:.0f} MHz = "
                   f"{derived / 1e12:.2f} T pairs/s; a pure FADD/FADD.abs kernel "
                   f"measured {measured / 1e12:.2f}; the larger"}


def probe_rate(torch, dev, symbol: str, per_step: float) -> float:
    """Operations/s of a rate probe of `csrc/coarse_topcap.cu` (16 chains a
    thread, 8 blocks of 256 threads per SM, 32 steps of `per_step`
    operations a thread an iteration)."""
    import ctypes

    from emosaic_tpu_torch.ops._kernels import COARSE_TOPCAP

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = getattr(ctypes.CDLL(str(COARSE_TOPCAP.library)), symbol)
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks, iters = sms * 8, 1024

    def run():
        check(fn(dev.index, out.data_ptr(), blocks, iters, stream) == 0, f"{symbol} launch")

    ms = cuda_ms(torch, run, reps=3)
    return blocks * 256 * 32 * iters * per_step / (ms * 1e-3)


def vabsdiff2_rate(torch, dev, card) -> float:
    """Pairs/s of the packed 16-bit probe of `csrc/coarse_topcap.cu` (one
    `vabsdiff2.u32.u32.u32.add` = two pairs): sm_90a expands it into a
    sequence, so K9 keeps f32 operands (PERF.md)."""
    measured = probe_rate(torch, dev, "emosaic_vabsdiff2_rate", 2)
    log(f"packed 16-bit vabsdiff2.add: {measured / 1e12:.2f} T pairs/s (not an sm_90a "
        f"instruction; the FP32 path does two FADDs a pair) [{card}]")
    return measured


def vimnmx_rate(torch, dev, card) -> float:
    """VIMNMX/s of the selection's integer min/max probe of
    `csrc/coarse_topcap.cu` (branch-free inserts into sorted lists, as K9's
    selection runs them): what bounds K9's selection."""
    measured = probe_rate(torch, dev, "emosaic_vimnmx_rate", 3.5)  # 112 an iteration
    log(f"integer min/max (VIMNMX) alone: {measured / 1e12:.2f} T/s [{card}]")
    return measured


def ceiling(nbytes: float, pairs: float, rate: dict) -> dict:
    """The least time the CUDA cores could take: the byte pairs at the
    VABSDIFF4 rate, or the bytes at the memory rate, whichever is larger."""
    return {"ceiling_ms": max(pairs / rate["rate"], nbytes / HBM_BYTES_PER_S) * 1e3,
            "ceiling_by": rate["how"]}


def sass_share(lib: Path, name_part: str) -> float:
    """The VABSDIFF4 share of one kernel's instructions in the built library
    (`cuobjdump -sass`, static count of the kernel's code)."""
    import re

    from emosaic_tpu_torch.ops._kernels import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for part in text.split("Function : ")[1:]:
        if name_part in part.split("\n", 1)[0]:
            ops = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part)]
            return sum(o == "VABSDIFF4" for o in ops) / max(1, len(ops))
    raise AssertionError(f"no kernel named like {name_part} in {lib}")


class Err:
    """Largest |kernel - plain| seen over a kernel's comparisons."""

    def __init__(self):
        self.max = 0

    def add(self, torch, got, want, what: str) -> None:
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
              f"{tuple(want.shape)}")
        g, w = got.reshape(-1), want.reshape(-1)
        err, step = 0, 1 << 28  # int64 chunks: a band past 4 GiB fits
        for i in range(0, g.numel(), step):
            diff = (g[i : i + step].to(torch.int64) - w[i : i + step].to(torch.int64)).abs()
            err = max(err, int(diff.max()))
        self.max = max(self.max, err)
        check(err == 0, f"{what}: kernel differs from plain, max |err| = {err}")


# ---------------------------------------------------------------------------
# A, B
# ---------------------------------------------------------------------------


def phase_a(torch) -> str:
    log("== A. environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")
    from emosaic_tpu_torch.ops._kernels import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    log(nvcc.stdout.strip().splitlines()[-1])
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    log(f"torch.cuda.is_available(): True, {torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}")
    return card


def phase_b() -> None:
    from emosaic_tpu_torch import native
    from emosaic_tpu_torch.ops._kernels import KERNELS, build_all

    log("== B. build")
    t0 = time.perf_counter()
    secs = build_all(KERNELS, force=True)
    for k in {k.source_name: k for k in KERNELS}.values():
        names = [j.name for j in KERNELS if j.source_name == k.source_name]
        log(f"built {k.source.relative_to(ROOT)} -> {k.library.relative_to(ROOT)} "
            f"({', '.join(names)}) in {secs[k.source_name]:.2f} s")
    log(f"all kernels in {time.perf_counter() - t0:.2f} s (one nvcc per source, together)")
    secs = native.build(force=True)
    check(native.available(), "the native greedy engine did not load")
    log(f"built {native.SOURCE.relative_to(ROOT)} -> "
        f"{native.library_path().relative_to(ROOT)} in {secs:.2f} s")


# ---------------------------------------------------------------------------
# C
# ---------------------------------------------------------------------------


def _u8(torch, gen, shape, dev):
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)


def phase_c_k1(torch, gen, dev, card, rate) -> dict:
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.ops._kernels import L1_ARGMIN

    err = Err()
    shapes = [(1, 3, 3), (5, 700, 12), (300, 513, 12), (70, 100, 200),
              (1536, 240, 3), (257, 1000, 192), (100, 600, 3072), (33, 50, 75)]
    for b, l, d in shapes:
        blocks, lib = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
        got = distance.l1_argmin(blocks, lib)
        want = distance.l1_argmin_ref(blocks, lib)
        err.add(torch, torch.stack(got), torch.stack(want), f"K1 B={b} L={l} D={d}")
    log(f"K1 test shapes {shapes}: exact")
    # tie storms: every library row repeated, so the lowest row must win;
    # the second one is small-B / large-L, which splits L across blocks
    for nbase, reps, d, b in [(40, 3, 12, 17), (5000, 4, 12, 17), (300, 2, 48, 4000)]:
        base = _u8(torch, gen, (nbase, d), dev)
        lib = base.repeat(reps, 1)
        pick = torch.randint(0, nbase, (b,), device=dev, generator=gen)
        dist, row = distance.l1_argmin(base[pick], lib)
        torch.cuda.synchronize()
        check(bool((dist == 0).all()) and bool((row == pick.to(torch.int32)).all()),
              f"K1 tie storm {nbase}x{reps}: not the lowest row")
        want = distance.l1_argmin_ref(base[pick], lib)
        err.add(torch, torch.stack((dist, row)), torch.stack(want), "K1 tie storm")
    one = _u8(torch, gen, (1, 48), dev).repeat(100000, 1)
    dist, row = distance.l1_argmin(_u8(torch, gen, (64, 48), dev), one)
    torch.cuda.synchronize()
    check(bool((row == 0).all()), "K1: all-equal library must give row 0")
    log("K1 tie storms: lowest row wins, exact")
    # the widest rows: all-0 blocks against an all-255 library tie over the
    # whole library (across tiles and splits) at distances past 2^24; then
    # one row of the ragged last tile one lower wins
    for d in (49152, 65800):
        blocks = torch.zeros((3, d), dtype=torch.uint8, device=dev)
        lib = torch.full((300, d), 255, dtype=torch.uint8, device=dev)
        got = distance.l1_argmin(blocks, lib)
        torch.cuda.synchronize()
        check(bool((got[0] == 255 * d).all()) and bool((got[1] == 0).all()),
              f"K1 D={d}: the all-255 tie must give row 0")
        err.add(torch, torch.stack(got), torch.stack(distance.l1_argmin_ref(blocks, lib)),
                f"K1 D={d} tie")
        lib[290, 7] = 254
        got = distance.l1_argmin(blocks, lib)
        torch.cuda.synchronize()
        check(bool((got[0] == 255 * d - 1).all()) and bool((got[1] == 290).all()),
              f"K1 D={d}: row 290 one lower must win")
        log(f"K1 D={d}: all-0 blocks vs an all-255 library give {255 * d} at row 0 (ties "
            "across tiles and splits); one row of the ragged last tile one lower wins: exact")
        del blocks, lib
    # across D at B=4096 against 200k rows (exact on a sample of queries)
    l = 200000
    by_d = {}
    for d in (12, 48, 192, 768, 3072):
        blocks, lib = _u8(torch, gen, (4096, d), dev), _u8(torch, gen, (l, d), dev)
        got = distance.l1_argmin(blocks, lib)
        s = torch.arange(0, 4096, 256 if d >= 768 else 64, device=dev)
        err.add(torch, torch.stack(got)[:, s], torch.stack(distance.l1_argmin_ref(blocks[s], lib)),
                f"K1 B=4096 D={d} (sample)")
        by_d[d] = cuda_ms(torch, lambda: distance.l1_argmin(blocks, lib), reps=3)
        log(f"K1 B=4096 L={l} D={d}: {by_d[d]:.3f} ms, {4096 * l * d / by_d[d] / 1e9:.2f} "
            f"T byte pairs/s (sample exact) [{card}]")
        del blocks, lib
    torch.cuda.empty_cache()
    # the main-path shape: a 2048^2 source at mode 4 against 100k tiles
    b, l, d = 262144, 200000, 48
    blocks, lib = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
    t0 = time.perf_counter()
    dist, row = distance.l1_argmin(blocks, lib)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    sample = torch.arange(0, b, b // 4096, device=dev)
    want = distance.l1_argmin_ref(blocks[sample], lib)
    err.add(torch, torch.stack((dist[sample], row[sample])), torch.stack(want),
            "K1 main-path shape (4096-block sample)")
    ms_full = cuda_ms(torch, lambda: distance.l1_argmin(blocks, lib), reps=3)
    sub = blocks[sample].contiguous()
    ms = cuda_ms(torch, lambda: distance.l1_argmin(sub, lib), reps=5)
    plain_ms = cuda_ms(torch, lambda: distance.l1_argmin_ref(sub, lib), reps=2)
    pairs = b * l * d
    nb_full = blocks.numel() + lib.numel() + 8 * b
    ceil_full = ceiling(nb_full, pairs, rate)
    share = sass_share(L1_ARGMIN.library, "l1_argmin_regILi12E")
    log(f"K1 B={b} L={l} D={d}: first call {first_s:.3f} s; {ms_full:.3f} ms "
        f"per call = {pairs / ms_full / 1e9:.2f} T byte pairs/s; CUDA-core ceiling "
        f"{ceil_full['ceiling_ms']:.2f} ms ({100 * ceil_full['ceiling_ms'] / ms_full:.1f}% of "
        f"it reached); VABSDIFF4 share of the D=48 kernel's SASS {share:.3f} [{card}]")
    log(f"K1 B=4096 L={l} D={d}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")
    nb = sub.numel() + lib.numel() + 8 * sub.shape[0]
    del blocks, lib, sub
    torch.cuda.empty_cache()
    # no single torch call computes an L1 argmin (cdist + argmin is two)
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms,
            **bound(nb, 2.0 * 4096 * l * d), **ceiling(nb, 4096 * l * d, rate),
            "library_ms": None, "shape": f"B=4096 L={l} D={d}",
            "ms_main_path_shape": ms_full, "main_path_shape": f"B={b} L={l} D={d}",
            "bound_ms_main_path_shape": bound(nb_full, 2.0 * pairs)["bound_ms"],
            "ceiling_ms_main_path_shape": ceil_full["ceiling_ms"],
            "ms_by_d_b4096_l200000": by_d, "vabsdiff4_sass_share_d48": share}


def edge_items(torch, gen, dev, t, nby, nbx):
    """Items [nby, nbx] uniform in [-t, t], the first eight 0, +-t, out of
    range and +-(2^31 - 1 or 2^31)."""
    it = torch.randint(-t, t + 1, (nby, nbx), dtype=torch.int32, device=dev,
                       generator=gen)
    edges = [0, t, -t, t + 7, -(t + 7), 1, 2**31 - 1, -(2**31)]
    it.view(-1)[: min(8, it.numel())] = torch.tensor(edges[: it.numel()],
                                                       dtype=torch.int32, device=dev)
    return it


def k2_bound(torch, items, aug) -> dict:
    """K2's bound, also K6's and K7's: the tiles the items reach, the items,
    and the band written."""
    from emosaic_tpu_torch.ops import composite

    ts = aug.shape[1]
    reached = int(torch.unique(composite.rows_of(items, aug.shape[0] // 2)).numel())
    tile_bytes = ts * ts * 3
    return bound(reached * tile_bytes + items.numel() * 4 + items.numel() * tile_bytes, 0)


def phase_c_k2(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.ops import composite

    err = Err()

    def items_for(t, nby, nbx):
        return edge_items(torch, gen, dev, t, nby, nbx)

    for t, ts, nby, nbx in [(5, 8, 3, 128), (1000, 12, 5, 300), (1000, 20, 5, 300),
                            (1000, 16, 4, 1000), (37, 32, 3, 77)]:
        aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
        items = items_for(t, nby, nbx)
        err.add(torch, composite.compose_rows(items, aug),
                composite.compose_rows_ref(items, aug), f"K2 T={t} ts={ts} nbx={nbx}")
    log("K2 ts 8/12/20/16/32, nbx 128/300/1000/77, items 0, +-T, out of range: exact")
    # the BASELINE band: 32 block-rows x 4096 tiles, ts = 32, T = 100k
    t, ts = 100000, 32
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    items = items_for(t, 32, 4096)
    err.add(torch, composite.compose_rows(items, aug),
            composite.compose_rows_ref(items, aug), "K2 BASELINE band")
    ms = cuda_ms(torch, lambda: composite.compose_rows(items, aug))
    plain_ms = cuda_ms(torch, lambda: composite.compose_rows_ref(items, aug))
    bound_k2 = k2_bound(torch, items, aug)
    # past the TPU path's 131072 tiles per call, in one call
    many = items_for(t, 40, 4096)
    err.add(torch, composite.compose_rows(many, aug),
            composite.compose_rows_ref(many, aug), "K2 163840 tiles in one call")
    band = 32 * ts * 4096 * ts * 3
    log("K2 163840 tiles (> 131072) in one call: exact")
    log(f"K2 BASELINE band {band / 1e6:.1f} MB: kernel {ms:.3f} ms "
        f"({2 * band / ms / 1e6:.0f} GB/s moved), plain {plain_ms:.3f} ms [{card}]")
    del aug
    torch.cuda.empty_cache()
    # a 9.8 GB stack (T = 100k, ts = 128), items aimed past 4 GiB
    t, ts = 100000, 128
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    row_bytes = ts * ts * 3
    first_far = (1 << 32) // row_bytes + 1
    far = torch.randint(first_far + 1, t + 1, (2, 512), dtype=torch.int32, device=dev,
                        generator=gen)
    far[1] = -far[1]  # mirrored rows: all past T * row_bytes
    got, want = composite.compose_rows(far, aug), composite.compose_rows_ref(far, aug)
    err.add(torch, got, want, "K2 9.8 GB stack")
    log(f"K2 stack {aug.numel() / 1e9:.2f} GB, items at rows >= {first_far} "
        f"(byte offset > 4 GiB): exact")
    del aug, got, want
    torch.cuda.empty_cache()
    # no single torch call gathers and lays out a band (index_select gives
    # [tiles, ts, ts*3]; the band order needs a second, permuting copy)
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms, **bound_k2,
            "library_ms": None, "shape": "items [32, 4096], T=100000, ts=32"}


def phase_c_k3(torch, gen, dev, card, rate) -> dict:
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.probes.k1_k3 import reuse

    err = Err()

    def one(b, l, d, m, what, lib=None):
        lib = _u8(torch, gen, (l, d), dev) if lib is None else lib
        blocks = _u8(torch, gen, (b, d), dev)
        # repeated candidates (drawn with replacement), row 0 and row L-1
        cand = torch.randint(0, l, (b, m), dtype=torch.int32, device=dev, generator=gen)
        cand[:, 0] = 0
        cand[:, -1] = l - 1
        if m > 2:
            cand[:, 1] = cand[:, 2]
        err.add(torch, distance.l1_rows(blocks, cand, lib),
                distance._l1_rows_ref(blocks, cand, lib), f"{what} B={b} L={l} D={d} m={m}")

    dims, ms_ = (3, 12, 48, 192, 768, 3072, 49152), (1, 7, 64, 1024)
    for d in dims:
        for m in ms_:
            one(5, 2000 if d < 49152 else 200, d, m, "K3")
    for d, m in ((768, 1024), (3072, 1024), (3072, 2000), (49152, 300)):
        one(37, 2000 if d < 49152 else 200, d, m, "K3 ragged groups")
    log(f"K3 D {dims} x m {ms_} (B=5: one ragged group), and B=37 on the grouped path "
        "(ragged last group, two passes at m=2000): exact with repeated and clamped "
        "candidates")
    # a 4.6 GB library; candidates past the 4 GiB byte offset
    l, d = 1_500_000, 3072
    lib = _u8(torch, gen, (l, d), dev)
    first_far = (1 << 32) // d + 1
    blocks = _u8(torch, gen, (64, d), dev)
    cand = torch.randint(first_far, l, (64, 256), dtype=torch.int32, device=dev,
                         generator=gen)
    cand[:, 0] = l - 1
    err.add(torch, distance.l1_rows(blocks, cand, lib),
            distance._l1_rows_ref(blocks, cand, lib), "K3 past 4 GiB")
    log(f"K3 library {lib.numel() / 1e9:.2f} GB, candidates at rows >= {first_far} "
        "(byte offset > 4 GiB): exact")
    del lib, blocks, cand
    torch.cuda.empty_cache()
    # the main-path shape: B=16384 blocks, m=1024 candidates, D=3072, L=65534
    b, l, d, m = 16384, 65534, 3072, 1024
    lib = _u8(torch, gen, (l, d), dev)
    blocks = _u8(torch, gen, (b, d), dev)
    cand = torch.randint(0, l, (b, m), dtype=torch.int32, device=dev, generator=gen)
    got = distance.l1_rows(blocks, cand, lib)
    err.add(torch, got, distance._l1_rows_ref(blocks, cand, lib), "K3 main-path shape")
    ms = cuda_ms(torch, lambda: distance.l1_rows(blocks, cand, lib))
    plain_ms = cuda_ms(torch, lambda: distance._l1_rows_ref(blocks, cand, lib), reps=2)
    reached = int(torch.unique(cand).numel())
    nb = blocks.numel() + cand.numel() * 4 + reached * d + b * m * 4
    gathered = b * m * d
    pairs = reuse(torch, cand, minhash=True)
    log(f"K3 B={b} m={m} D={d} L={l}: kernel {ms:.3f} ms ({gathered / ms / 1e9:.2f} TB/s "
        f"of gathered rows), plain {plain_ms:.3f} ms; {reached} rows reached; reuse "
        f"{pairs:.3f} pairs per fetched row in groups of 16 in min-hash order "
        f"({reuse(torch, cand):.3f} in consecutive groups; random candidates) "
        f"[{card}]")
    del lib, blocks, cand, got
    torch.cuda.empty_cache()
    # no single torch call gathers rows per query and reduces |x - t|
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms,
            **bound(nb, 2.0 * gathered), **ceiling(nb, gathered, rate), "library_ms": None,
            "shape": f"B={b} m={m} D={d} L={l}, random candidates",
            "gathered_gb": gathered / 1e9, "reuse_random": pairs}


def phase_c_k4(torch, gen, dev, card, b=16384, nseg_big=512) -> dict:
    from emosaic_tpu_torch.ops import distance

    err = Err()

    def stripe(r, nseg, hi):
        """A segment-major stripe with a full-tie segment and values at
        hi - 1, and the coarse pass's cols layout."""
        lp = nseg * 128
        dist = torch.randint(0, hi, (r, lp), dtype=torch.int32, device=dev, generator=gen)
        dist[:, :128] = 5
        dist[:, 64:128:3] = hi - 1
        pos = torch.arange(lp, device=dev)
        return dist, (pos % 128) * nseg + pos // 128

    def one(dist, cols, cap, real_l, what):
        got = distance.seg_topcap(dist, cols, cap, real_l)
        err.add(torch, got, distance._seg_topcap_ref(dist, cols, cap, real_l), what)

    nsegs = (1, 7, 512, 1563, 15625)
    for nseg in nsegs:
        r = max(2, min(96, (1 << 22) // (nseg * 128)))
        for cap in (1, 8, 16, 128):
            for hi in (40, 2**30):  # tie-heavy, and values up to 2^30 - 1
                dist, cols = stripe(r, nseg, hi)
                # the last 37 positions' rows are padding: _TL_BIG = 2^30
                one(dist, cols, cap, nseg * 128 - 37, f"K4 r={r} nseg={nseg} cap={cap}")
    log(f"K4 nseg {nsegs} x cap 1, 8, 16, 128 x values < 40 (ties) and < 2^30, full-tie "
        "segments, _TL_BIG-masked columns: exact")
    rng = np.random.default_rng(SEED)
    seg = rng.integers(0, 50, size=(32, 130, 128)).astype(np.int32)
    seg[0, 0, :] = 7
    seg[1, 3, 10:] = distance._TL_BIG
    for cap in (8, 16):
        got = distance.seg_topk(torch.as_tensor(seg, device=dev), cap)
        srt = torch.sort(torch.as_tensor(seg), dim=2, stable=True)  # the tool's contract
        want = (srt.values[:, :, :cap], srt.indices[:, :, :cap].to(torch.int32))
        for g_, w_ in zip(got, want):
            err.add(torch, g_.cpu(), w_, f"seg_topk [32, 130, 128] cap {cap}")
    log("K4 seg_topk [32, 130, 128] (the tool's case), cap 8 and 16: equal to a stable "
        "per-segment sort")
    # one call whose stripe passes 4 GiB; its first 16384 rows are the
    # flagship coarse pass's whole stripe (B=16384, lp=65536, cap 16)
    nseg, cap = nseg_big, 16
    dist, cols = stripe(b + 16, nseg, 1 << 20)
    real_l = nseg * 128 - 2
    one(dist, cols, cap, real_l, "K4 past 4 GiB")
    log(f"K4 stripe {dist.numel() * 4 / 2**30:.3f} GiB in one call: exact")
    flag = dist[:b]
    ms = cuda_ms(torch, lambda: distance.seg_topcap(flag, cols, cap, real_l))
    plain_ms = cuda_ms(torch, lambda: distance._seg_topcap_ref(flag, cols, cap, real_l),
                       reps=2)
    keys = distance._keys(flag.masked_fill(cols >= real_l, distance._TL_BIG), cols)
    lib_ms = cuda_ms(torch, lambda: torch.topk(keys.view(b, nseg, 128), cap, dim=2,
                                               largest=False), reps=2)
    # read the stripe and the cols once, write the keys once
    nb = flag.numel() * 4 + cols.numel() * 8 + b * nseg * cap * 8
    log(f"K4 B={b} lp={nseg * 128} cap={cap}: kernel {ms:.3f} ms "
        f"({nb / ms / 1e9:.2f} TB/s), plain {plain_ms:.3f} ms, torch.topk on the packed "
        f"keys {lib_ms:.3f} ms [{card}]")
    del dist, cols, flag, keys
    torch.cuda.empty_cache()
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms, **bound(nb, 0),
            "library_ms": lib_ms,
            "shape": f"B={b} lp={nseg * 128} nseg={nseg} cap={cap} (the flagship coarse "
                     "pass's whole stripe)"}


def phase_c_k9(torch, gen, dev, card, frate, b=16384, nseg_flag=512) -> dict:
    """K9 against its plain version `_coarse_topcap_ref` (keys and s_min
    exactly) at nseg 1, 7, 512 and 1563 with a ragged real_l, caps 1, 8 and
    16, and each dout the plan gives (modes 4/8, 16, 6, 32, 64, 128), on
    clustered projected data and on data whose rows repeat exactly across
    segments; then timed at the flagship coarse pass's shape against
    cdist + K4 and the plain version."""
    from emosaic_tpu_torch.ops import distance

    err = Err()

    def case(nseg, dout, g, kind, rows):
        """(xp [rows, dout] i32, coarse library) in projected units (group
        sums of g cells, 0..255g): 40 centres +-2g, or ("dupes", "storm") 50
        or 3 rows repeated over the whole library."""
        lp = nseg * 128
        top = 255 * g
        cen = torch.randint(0, top + 1, ({"clustered": 40, "dupes": 50, "storm": 3}[kind], dout),
                            device=dev, generator=gen)
        pick = torch.randint(0, cen.shape[0], (lp,), device=dev, generator=gen)
        rows_lib = cen[pick]
        if kind == "clustered":
            rows_lib = rows_lib + torch.randint(-2 * g, 2 * g + 1, (lp, dout), device=dev,
                                                generator=gen)
        rows_lib = rows_lib.clamp(0, top).to(torch.int32)
        qpick = torch.randint(0, lp, (rows,), device=dev, generator=gen)
        xp = (rows_lib[qpick] + torch.randint(-g, g + 1, (rows, dout), device=dev,
                                              generator=gen)).clamp(0, top).to(torch.int32)
        pos = torch.arange(lp, device=dev)
        cols = ((pos % 128) * nseg + pos // 128).to(torch.int32)
        # position s*128 + k holds library row cols = k*nseg + s
        proj = rows_lib.view(128, nseg, dout).permute(1, 2, 0).float().contiguous()
        return xp, (proj, cols, lp - 37)

    def one(xp, cl, cap, what):
        nseg = cl[0].shape[0]
        keys = torch.empty((xp.shape[0], nseg * cap), dtype=torch.int64, device=dev)
        s_min = torch.empty((xp.shape[0],), dtype=torch.int32, device=dev)
        distance.coarse_topcap(xp, cl, cap, keys, s_min)
        wk, ws = distance._coarse_topcap_ref(xp, cl[0], cl[1], cap, cl[2])
        err.add(torch, keys, wk, f"{what} keys")
        err.add(torch, s_min, ws, f"{what} s_min")

    douts = ((6, 8), (24, 32), (27, 4), (96, 32), (384, 32), (1536, 32))  # (dout, g)
    nsegs = (1, 7, 512, 1563)
    for dout, g in douts:
        for nseg in nsegs:
            rows = 300 if nseg * dout < 200000 else 133
            for kind in ("clustered", "dupes"):
                xp, cl = case(nseg, dout, g, kind, rows)
                for cap in (1, 8, 16):
                    one(xp, cl, cap, f"K9 nseg={nseg} dout={dout} cap={cap} {kind}")
                del xp, cl
    torch.cuda.empty_cache()
    log(f"K9 dout {[d_ for d_, _ in douts]} x nseg {nsegs} (real_l = lp - 37) x cap 1, 8, 16 "
        "x clustered and cross-segment duplicates: keys and s_min equal to the plain version")
    # the persistent grid's edges: (rows, nseg, dout, g, padding positions):
    # 3 items (fewer than the SMs), 153 and 240 items (not a multiple of
    # the SMs: blocks of two items, both teams, the ring wrapping), ragged
    # rows, real_l short of lp by 1 to 200 positions, dout 6, 27, 96 and
    # 1536 (96 stages an item); caps 1 to 33; "storm" repeats 3 rows over
    # the whole library (ties in every segment and across segments)
    edges = ((5, 3, 6, 8, 37), (300, 51, 27, 4, 200), (129, 7, 96, 32, 1), (1, 1, 6, 8, 100),
             (257, 2, 1536, 32, 37), (700, 40, 96, 32, 37))
    for rows, nseg, dout, g, pad in edges:
        for kind in ("clustered", "storm"):
            xp, (proj, cols, _) = case(nseg, dout, g, kind, rows)
            for cap in (1, 8, 16, 32, 33):
                one(xp, (proj, cols, nseg * 128 - pad), cap,
                    f"K9 edge rows={rows} nseg={nseg} dout={dout} cap={cap} {kind}")
            del xp, proj, cols
    log(f"K9 persistent-grid edges (rows, nseg, dout, g, padding) {edges} x cap 1, 8, 16, 32, "
        "33 x clustered and tie storms: keys and s_min equal to the plain version")

    # the flagship coarse pass: B=16384 projected blocks (dout 96) against
    # 512 segments, cap 16, in one call
    cap, dout = 16, 96
    xp, cl = case(nseg_flag, dout, 32, "clustered", b)
    proj, cols, real_l = cl
    lp = nseg_flag * 128
    keys = torch.empty((b, nseg_flag * cap), dtype=torch.int64, device=dev)
    s_min = torch.empty((b,), dtype=torch.int32, device=dev)
    one(xp, cl, cap, "K9 flagship shape")
    ms = cuda_ms(torch, lambda: distance.coarse_topcap(xp, cl, cap, keys, s_min))
    rows_lib = distance._ad_rows(proj)

    def stripe_k4():
        return distance.seg_topcap(distance.l1_block(xp, rows_lib), cols, cap, real_l)

    check(torch.equal(stripe_k4(), keys), "cdist + K4 != K9 at the flagship shape")
    pair_ms = cuda_ms(torch, stripe_k4, reps=2)
    stripe_ms = cuda_ms(torch, lambda: distance.l1_block(xp, rows_lib), reps=2)
    plain_ms = cuda_ms(torch, lambda: distance._coarse_topcap_ref(xp, proj, cols, cap, real_l),
                       reps=1)
    pairs = b * lp * dout
    # read the projected rows, the library and the cols once; write keys and s_min
    nb = xp.numel() * 4 + proj.numel() * 4 + cols.numel() * 4 + keys.numel() * 8 + b * 4
    res = {**bound(nb, 2.0 * pairs), **ceiling(nb, pairs, frate)}
    # the issue floor: two FADDs a pair and the selection's 2 * 16 + 4
    # instructions a position, at 4 warp instructions an SM a clock (the
    # FP32 rate's clock: 64 pairs = 128 thread instructions an SM a clock)
    floor_ms = b * lp * (2 * dout + 36) / (2 * frate["derived"]) * 1e3
    log(f"K9 B={b} lp={lp} dout={dout} cap={cap}: kernel {ms:.3f} ms "
        f"({pairs / ms / 1e9:.2f} T pairs/s), bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']}), FP32 ceiling {res['ceiling_ms']:.3f} ms, issue floor "
        f"{floor_ms:.3f} ms; cdist + K4 {pair_ms:.3f} ms (the cdist stripe alone "
        f"{stripe_ms:.3f} ms); plain {plain_ms:.3f} ms [{card}]")
    del xp, cl, proj, cols, keys, s_min, rows_lib
    torch.cuda.empty_cache()
    # one launch at the 200k shape (the lab probe's chunk: 1341 rows x 1563
    # segments, cap 8)
    xp, cl = case(1563, dout, 32, "clustered", 1341)
    keys = torch.empty((1341, 1563 * 8), dtype=torch.int64, device=dev)
    s_min = torch.empty((1341,), dtype=torch.int32, device=dev)
    one(xp, cl, 8, "K9 200k shape")
    ms_200k = cuda_ms(torch, lambda: distance.coarse_topcap(xp, cl, 8, keys, s_min))
    log(f"K9 1341 rows x 1563 segments x dout {dout}, cap 8 (the 200k shape): {ms_200k:.3f} ms "
        f"[{card}]")
    del xp, cl, keys, s_min
    torch.cuda.empty_cache()
    # no single torch call computes the fused function; library_ms is the
    # cdist stripe it replaces
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms, **res,
            "library_ms": stripe_ms, "cdist_k4_ms": pair_ms, "issue_floor_ms": floor_ms,
            "ms_200k": ms_200k, "fp32_rate_measured": frate["measured"],
            "vabsdiff2_rate_measured": vabsdiff2_rate(torch, dev, card),
            "vimnmx_rate_measured": vimnmx_rate(torch, dev, card),
            "shape": f"B={b} lp={lp} nseg={nseg_flag} dout={dout} cap={cap} (the flagship "
                     "coarse pass in one call)"}


def phase_c_k10(torch, gen, dev, card, rate, b=16384, l=65534,
                p4=(4096, 32767)) -> tuple[dict, dict]:
    """K10's two entry points against their plain versions, exactly: the
    stripe (`l1_block` on u8 rows against `_l1_block_ref`) at D 3..49152
    with ragged rows, and the fused top-cap (`l1_topcap` against
    `_l1_topcap_ref`) at caps 1..32 and 33, on tie storms, a padded last
    segment, a col0 offset and rows past 2^24; the persistent grid's edges
    (fewer tiles than SMs, tile counts not a multiple of the SMs, D not a
    multiple of the 64-word stage: 3, 48, 3088, 65800) and ties across the
    two threads that select a row; then at the worst case's
    shape (uniform B=16384 against L=65534 rows of D=3072, cap 8; exact on
    a row sample) and at P4's shard shape (4096 rows against 32767 of D=48,
    cap 16, col0 = 32767, whole). Timed: the stripe against
    `torch.cdist(p=1)` at phase N's [4096, 3072] x [65534, 3072] chunk, the
    top-cap against cdist + the per-segment `_least` it replaces, each
    beside its bound and its VABSDIFF4 ceiling. Returns (stripe, top-cap)."""
    from emosaic_tpu_torch.ops import distance

    es, et = Err(), Err()

    def stripe_case(r, n, d):
        x, t = _u8(torch, gen, (r, d), dev), _u8(torch, gen, (n, d), dev)
        es.add(torch, distance.l1_block(x, t), distance._l1_block_ref(x, t),
               f"K10 stripe r={r} L={n} D={d}")

    shapes = [(r, n, d) for d in (3, 12, 48, 768, 3072) for r, n in ((1, 1), (130, 300), (257, 1000))]
    for r, n, d in shapes + [(130, 300, 49152)]:
        stripe_case(r, n, d)
    log(f"K10 stripe at D 3..49152, rows 1..257 x library 1..1000: exact [{card}]")

    def topcap_case(x, t, cap, col0, real_l, what):
        et.add(torch, distance.l1_topcap(x, t, cap, col0=col0, real_l=real_l),
               distance._l1_topcap_ref(x, t, cap, col0, real_l), what)

    for d in (3, 12, 48, 768, 3072):
        caps = range(1, 34) if d == 48 else (1, 8, 16, 32, 33)
        for kind in ("uniform", "storm"):
            if kind == "storm":  # four distinct rows: every segment's cap cuts a tie
                t = _u8(torch, gen, (4, d), dev).repeat(250, 1)
            else:
                t = _u8(torch, gen, (1000, d), dev)
            x = _u8(torch, gen, (130, d), dev)
            x[0] = t[500]
            for cap in caps:
                topcap_case(x, t, cap, 0, 1000, f"K10 top-cap D={d} cap={cap} {kind}")
    x, t = _u8(torch, gen, (300, 48), dev), _u8(torch, gen, (640, 48), dev)
    for col0, real_l in ((1000, 1200), (4096, 10**6), (128, 128), (0, 700)):
        for cap in (8, 16, 40):
            topcap_case(x, t, cap, col0, real_l, f"K10 top-cap col0={col0} real_l={real_l}")
    # the persistent grid and the ring of 64-word stages: fewer tiles than
    # SMs, tile counts that are not a multiple of the SMs, ragged rows and
    # library, D not a multiple of the stage; then ties across the two
    # threads that select a row
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r, n in ((130, 1000), (257, 129 * 128 + 5), (2100, 2200)):
        check((distance._k10_plan(r, n, 48, sms)[2] < sms) == (r == 130),
              f"K10 edge shape {r} x {n}: tiles against SMs")
        for d in (3, 48, 3088):
            stripe_case(r, n, d)
            x, t = _u8(torch, gen, (r, d), dev), _u8(torch, gen, (n, d), dev)
            for cap in (1, 8, 16, 32, 33):
                topcap_case(x, t, cap, 77, 77 + n - 3, f"K10 top-cap {r} x {n} D={d} cap={cap}")
    x = _u8(torch, gen, (200, 48), dev)
    row = _u8(torch, gen, (1, 48), dev)
    for t in (row.repeat(1000, 1), torch.cat([row, 255 - row]).repeat(500, 1)):
        for cap in (1, 8, 16, 32, 33):
            topcap_case(x, t, cap, 0, 1000, f"K10 top-cap tie storm across the pair, cap={cap}")
    log(f"K10 at fewer tiles than the {sms} SMs and at 390 and 306 tiles, D 3, 48, 3088, caps "
        "1..33 with padding, ties across the selecting pair: exact")
    x = torch.zeros((3, 65800), dtype=torch.uint8, device=dev)
    t = torch.full((300, 65800), 255, dtype=torch.uint8, device=dev)
    t[290, 7] = 254
    topcap_case(x, t, 8, 0, 300, "K10 top-cap D=65800 (rank path, ties past 2^24)")
    stripe_case(3, 200, 65800)
    got = distance.l1_topcap(x, t, 8)
    torch.cuda.synchronize()
    check(int(got[0, 2, 0] >> 32) == 255 * 65800 - 1 and int(got[0, 2, 0] & 0xFFFFFFFF) == 290,
          "K10 D=65800: row 290 one lower must lead its segment")
    del x, t, got
    log("K10 top-cap at D 3..3072 x caps 1..33 (every cap at D=48), tie storms, a padded last "
        "segment, col0 offsets with real_l inside and before the shard, D=65800: exact")

    # the worst case's shape: uniform data, cap 8, exact on a row sample
    d = 3072
    x, t = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
    nseg = -(-l // 128)
    keys = distance.l1_topcap(x, t, 8)
    s = torch.arange(0, b, b // 64, device=dev)
    topcap_wc = distance._l1_topcap_ref(x[s], t, 8, 0, l)
    et.add(torch, keys[s], topcap_wc, f"K10 top-cap worst-case shape B={b} L={l} (64-row sample)")
    ms_wc = cuda_ms(torch, lambda: distance.l1_topcap(x, t, 8), reps=3)
    pairs_wc = b * l * d
    nb_wc = x.numel() + t.numel() + keys.numel() * 8
    del keys, topcap_wc
    # same inputs for the kernel, its plain version and cdist + _least: 512 rows
    rs, rc, rp = min(512, b), min(4096, b), min(256, b)  # the timed row counts
    xs = x[:rs].contiguous()
    cols = torch.arange(nseg * 128, device=dev)
    tf = t.float()

    def cdist_least():
        dist = torch.nn.functional.pad(torch.cdist(xs.float(), tf, p=1).to(torch.int32),
                                       (0, nseg * 128 - l), value=distance.I32_MAX)
        return distance._least(distance._keys(dist, cols).view(-1, nseg, 128), 8)

    check(torch.equal(cdist_least(), distance.l1_topcap(xs, t, 8)), "cdist + _least != K10")
    tc_ms = cuda_ms(torch, lambda: distance.l1_topcap(xs, t, 8))
    tc_plain_ms = cuda_ms(torch, lambda: distance._l1_topcap_ref(xs, t, 8, 0, l), reps=1)
    tc_cdist_ms = cuda_ms(torch, cdist_least, reps=2)
    pairs = rs * l * d
    nb = xs.numel() + t.numel() + rs * nseg * 8 * 8
    tc = {"ms": tc_ms, "plain_ms": tc_plain_ms, **bound(nb, 2.0 * pairs),
          **ceiling(nb, pairs, rate), "library_ms": None, "cdist_least_ms": tc_cdist_ms,
          "shape": f"{rs} rows x L={l} D={d} cap 8",
          "ms_worst_case_shape": ms_wc, "worst_case_shape": f"B={b} L={l} D={d} cap 8",
          "bound_ms_worst_case_shape": bound(nb_wc, 2.0 * pairs_wc)["bound_ms"],
          "ceiling_ms_worst_case_shape": ceiling(nb_wc, pairs_wc, rate)["ceiling_ms"]}
    log(f"K10 top-cap {tc['worst_case_shape']}: {ms_wc:.3f} ms ({pairs_wc / ms_wc / 1e9:.2f} T "
        f"byte pairs/s), bound {tc['bound_ms_worst_case_shape']:.3f} ms, VABSDIFF4 ceiling "
        f"{tc['ceiling_ms_worst_case_shape']:.3f} ms [{card}]")
    log(f"K10 top-cap {tc['shape']}: kernel {tc_ms:.3f} ms, bound {tc['bound_ms']:.3f} ms "
        f"({tc['bound_by']}), ceiling {tc['ceiling_ms']:.3f} ms; plain {tc_plain_ms:.3f} ms; "
        f"cdist + _least per segment {tc_cdist_ms:.3f} ms [{card}]")

    # the stripe at phase N's chunk: [4096, 3072] x [65534, 3072], against
    # cdist; the kernel, its plain version and cdist on the same 256 rows
    x4 = x[:rc].contiguous()
    out = distance.l1_block(x4, t)
    es.add(torch, out[::64], distance._l1_block_ref(x4[::64], t),
           f"K10 stripe [{rc}, {d}] x [{l}, {d}] (sample)")
    st_main_ms = cuda_ms(torch, lambda: distance.l1_block(x4, t), reps=3)
    xf = x4.float()
    check(torch.equal(torch.cdist(xf, tf, p=1).to(torch.int32), out), "cdist != K10 stripe")
    del out
    st_main_cdist_ms = cuda_ms(torch, lambda: torch.cdist(xf, tf, p=1), reps=2)
    xp = x[:rp].contiguous()
    xpf = xp.float()
    st_ms = cuda_ms(torch, lambda: distance.l1_block(xp, t))
    st_plain_ms = cuda_ms(torch, lambda: distance._l1_block_ref(xp, t), reps=1)
    st_cdist_ms = cuda_ms(torch, lambda: torch.cdist(xpf, tf, p=1), reps=2)
    pairs, pairs_main = rp * l * d, rc * l * d
    nb, nb_main = xp.numel() + t.numel() + 4 * rp * l, x4.numel() + t.numel() + 4 * rc * l
    st = {"ms": st_ms, "plain_ms": st_plain_ms, **bound(nb, 2.0 * pairs),
          **ceiling(nb, pairs, rate), "library_ms": st_cdist_ms,
          "shape": f"[{rp}, {d}] x [{l}, {d}]",
          "ms_main_path_shape": st_main_ms, "library_ms_main_path_shape": st_main_cdist_ms,
          "main_path_shape": f"[{rc}, {d}] x [{l}, {d}] (phase N's stripe chunk)",
          "bound_ms_main_path_shape": bound(nb_main, 2.0 * pairs_main)["bound_ms"],
          "ceiling_ms_main_path_shape": ceiling(nb_main, pairs_main, rate)["ceiling_ms"]}
    log(f"K10 stripe {st['main_path_shape']}: {st_main_ms:.3f} ms "
        f"({pairs_main / st_main_ms / 1e9:.2f} T byte pairs/s), bound "
        f"{st['bound_ms_main_path_shape']:.3f} ms, VABSDIFF4 ceiling "
        f"{st['ceiling_ms_main_path_shape']:.3f} ms; torch.cdist(p=1) f32 "
        f"{st_main_cdist_ms:.1f} ms ({st_main_cdist_ms / st_main_ms:.1f}x the kernel) [{card}]")
    log(f"K10 stripe {st['shape']}: kernel {st_ms:.3f} ms, bound {st['bound_ms']:.3f} ms "
        f"({st['bound_by']}), ceiling {st['ceiling_ms']:.3f} ms; plain {st_plain_ms:.3f} ms; "
        f"torch.cdist(p=1) {st_cdist_ms:.3f} ms [{card}]")
    if st_main_ms >= st_main_cdist_ms:
        log("K10 stripe: SLOWER than torch.cdist(p=1) at phase N's chunk")
    del x, t, tf, xf, x4, xs, xp, xpf
    torch.cuda.empty_cache()

    # P4's second library shard: 4096 rows x 32767, D=48, cap 16, global cols
    x, t = _u8(torch, gen, (p4[0], 48), dev), _u8(torch, gen, (p4[1], 48), dev)
    topcap_case(x, t, 16, p4[1], 2 * p4[1], f"K10 top-cap P4 shard ({p4[0]} x {p4[1]}, D=48, "
                "cap 16)")
    p4_ms = cuda_ms(torch, lambda: distance.l1_topcap(x, t, 16, col0=p4[1], real_l=2 * p4[1]))
    log(f"K10 top-cap at P4's shard shape: exact, {p4_ms:.3f} ms [{card}]")
    del x, t
    torch.cuda.empty_cache()
    st["max_abs_err"], tc["max_abs_err"] = es.max, et.max
    tc["ms_p4_shard"] = p4_ms
    return st, tc


def phase_c_k12(torch, dev, card, rate) -> dict:
    """K12 (`masked_refill`) against its plain version, exactly, at the
    `generate_m32` refill's shape (65534 rows of 3072 bytes, 37000 unused,
    k = 256) at M 1, 4 and one past the crossover, and at ragged
    libraries, rows of 24..3088 bytes, masks with none, half and all rows
    used and k 1..256 (`probes/k12.py` `exact_checks`); then timed at that
    shape at M = 1, 4, 64, `_K12_MAX_M` and twice it (`probes/k12.py`
    `sweep`): the kernel, its plain version at M = 1, the chain it
    replaces below the crossover (gather, K10's stripe, the packed-key
    top-k) as the yardstick, and a whole refill call on each route, beside
    the bound (the unused rows, the mask and the blocks over 3.35 TB/s)
    and the VABSDIFF4 ceiling. The crossover it reports is the one this
    run measures: the largest of those Ms up to which a call on K12 beats
    one on the stripe's route."""
    from emosaic_tpu_torch.ops import refill
    from emosaic_tpu_torch.probes import k12 as probe

    probe.exact_checks(torch, dev, refill)
    cap = refill._K12_MAX_M
    swept = probe.sweep(torch, dev, refill, sorted({1, 4, 64, cap, min(2 * cap, 4096)}))
    rows = {r["m"]: r for r in swept}
    crossover = probe.measured_crossover(swept)
    _, lib, blocks, used = probe.scene(torch, dev)
    ids = torch.arange(1, device=dev)
    plain_ms = cuda_ms(torch, lambda: refill._masked_refill_ref(blocks, ids, lib, used, 256),
                       reps=2)
    del lib, blocks, used
    torch.cuda.empty_cache()
    res = {}
    for m, r in rows.items():
        nbytes = probe.UNUSED * probe.D + probe.L + m * probe.D + 2 * m * 256 * 4
        pairs = m * probe.UNUSED * probe.D
        sfx = "" if m == 1 else f"_m{m}"
        res.update({f"ms{sfx}": r["k12_ms"], f"chain_ms{sfx}": r["chain_ms"],
                    f"call_ms{sfx}": r["call_k12_ms"], f"call_stripe_ms{sfx}": r["call_stripe_ms"],
                    f"bound_ms{sfx}": bound(nbytes, 2.0 * pairs)["bound_ms"],
                    f"ceiling_ms{sfx}": ceiling(nbytes, pairs, rate)["ceiling_ms"]})
        log(f"K12 M={m} over {probe.UNUSED} of {probe.L} rows x {probe.D} B, k 256: "
            f"{r['k12_ms']:.4f} ms, bound {res[f'bound_ms{sfx}']:.4f}, ceiling "
            f"{res[f'ceiling_ms{sfx}']:.4f}; the chain it replaces {r['chain_ms']:.4f} ms; a "
            f"call {r['call_k12_ms']:.4f} ms, on the stripe's route {r['call_stripe_ms']:.4f} "
            f"[{card}]")
    log(f"K12 measured crossover: a call on K12 beats one on the stripe's route up to M = "
        f"{crossover} of the Ms above (`_K12_MAX_M` {cap}) [{card}]")
    res.update(plain_ms=plain_ms, library_ms=None, crossover_measured=crossover,
               shape=f"M=1 x {probe.UNUSED} unused of {probe.L} rows x {probe.D} B, k 256",
               yardstick="chain_ms: gather + K10's stripe + packed-key torch.topk")
    log(f"K12 plain version at M=1: {plain_ms:.3f} ms [{card}]")
    return res


def phase_c_k13(torch, dev, card) -> dict:
    """K13 (`row_sort`) against its plain version, exactly, at the cases of
    `probes/k13.py` `exact_checks`; then timed there (`timings`) at the
    `service_m16` cell's [4096, 8192] matrix and at the route's longest
    rows [3051, 65534]: the kernel beside its bound, its plain version and
    `torch.sort` of the same packed keys (the yardstick), and at the cell's
    shape the whole `sorted_lists` call on the host's clock against the
    host sort it replaces."""
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.probes import k13 as probe

    exact = probe.exact_checks(torch, dev, distance)
    t = probe.timings(torch, dev, distance, card)
    cell, edge = t["cell"], t["edge"]
    return {"ms": cell["ms"], "bound_ms": cell["bound_ms"], "bound_by": "bytes",
            "plain_ms": cell["plain_ms"], "library_ms": cell["library_ms"],
            "shape": cell["shape"], "yardstick": cell["library"],
            "ms_long_rows": edge["ms"], "bound_ms_long_rows": edge["bound_ms"],
            "plain_ms_long_rows": edge["plain_ms"], "library_ms_long_rows": edge["library_ms"],
            "shape_long_rows": edge["shape"], "sorted_lists_s": cell["sorted_lists_s"],
            "copy_s": cell["copy_s"], "host_sort_s": cell["host_sort_s"], "exact": exact}


def phase_c_k11(torch, gen, dev, card, mode4=(262144, 200000, 48), flag=(4096, 65534, 3072),
                rows_t=16384) -> tuple[dict, dict]:
    """K11's two entry points against their plain versions, bit for bit:
    the argmin (`distance._l2_argmin` against `_l2_argmin_ref`) and the
    per-segment top-cap (`l2_topcap` against `_l2_topcap_ref`) at phase
    H's mode-4 shape (262144 x 200000 x 48, the top-cap with the hybrid
    prefilter's plan for k_pre = 64; the plain versions on a row sample),
    at the flagship chunk [4096, 3072] x [65534, 3072] (the plan for k_pre
    = 1024; sampled), at D = 12, 768 and 49152 on a few hundred rows
    (padding to 32 bytes, the split depth), every segment length, caps 1
    to 32 and, ranking the whole segment, up to the segment, tie storms
    (duplicated rows, a library of four rows) and col0 / real_l padding.
    The hybrid prefilter where k_pre is too large a share of the library
    for a fast plan (flagship-width rows against 20000, 4000 and 1100
    library rows, k_pre = 1024) runs with the plain versions refused and
    equals them on a row sample. Timed with CUDA events (mean of 5) on the first
    `rows_t` rows of the mode-4 shape, beside the bound and the route each
    replaces ("library": the f32 `"highest"` `torch.matmul` score stripes
    of `|t|^2 - 2 x.t` in row chunks, then their argmin, or the packed keys
    of their order image and a `torch.topk` per segment), and at the whole
    mode-4 shape and the flagship chunk. Returns (argmin, top-cap)."""
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.ops._kernels import L2_TOPCAP

    ea, et = Err(), Err()

    def argmin_case(x, t, what):
        got, want = distance._l2_argmin(x, t), distance._l2_argmin_ref(x, t)
        ea.add(torch, got[0], want[0], what + " (dist^2)")
        ea.add(torch, got[1], want[1], what + " (row)")

    def topcap_case(x, t, cap, seg, col0, real_l, what, prepared=None):
        et.add(torch, distance.l2_topcap(x, t, cap, seg=seg, col0=col0, real_l=real_l,
                                         prepared=prepared),
               distance._l2_topcap_ref(x, t, cap, seg, col0, real_l), what)

    def lib_of(kind, l, d):
        if kind == "storm":  # four distinct rows: every cut falls in a tie
            return _u8(torch, gen, (4, d), dev).repeat(-(-l // 4), 1)[:l].contiguous()
        t = _u8(torch, gen, (l, d), dev)
        if kind == "duplicates":
            t[l // 2 :] = t[: l - l // 2].clone()
        return t

    for d in (12, 48, 128, 129, 768, 3072, 4128, 49152):
        for kind in ("uniform", "duplicates", "storm"):
            t = lib_of(kind, 3001 if d < 49152 else 301, d)
            x = _u8(torch, gen, (257 if d < 49152 else 40, d), dev)
            x[0] = t[t.shape[0] // 2]
            argmin_case(x, t, f"K11 argmin D={d} {kind}")
            if d in (128, 129, 4128):
                continue
            for seg in distance._K11_SEGS:
                for cap in ((1, 7, 16, 24, 32) if d == 48 else (1, 24)):
                    topcap_case(x, t, cap, seg, 0, t.shape[0],
                                f"K11 top-cap D={d} seg={seg} cap={cap} {kind}")
            for seg, cap in ((128, 33), (128, 100), (128, 128), (512, 64)):
                if d in (12, 48, 768, 49152):
                    topcap_case(x, t, cap, seg, 0, t.shape[0],
                                f"K11 top-cap D={d} seg={seg} cap={cap} (ranked) {kind}")
    x, t = _u8(torch, gen, (300, 48), dev), lib_of("duplicates", 900, 48)
    for col0, real_l in ((1000, 1200), (4096, 10**6), (128, 128), (0, 700)):
        for seg, cap in ((128, 8), (1024, 32), (128, 77)):
            topcap_case(x, t, cap, seg, col0, real_l, f"K11 top-cap col0={col0} real_l={real_l}")
    log(f"K11 at D 12..49152 (the packed argmin key's widest rows, 128, and past it), every "
        f"segment length, caps 1..32 and "
        f"ranked caps up to the whole segment, duplicated rows and tie storms, col0 / real_l "
        f"padding: exact [{card}]")

    # the prefilter past every fast plan: 128-row segments with caps of 21
    # (group minima), 60 (ranked) and 128 (kept whole), through K11 alone
    nr_rows = {}
    for l in (20000, 4000, 1100):
        x, t = _u8(torch, gen, (4096, 3072), dev), _u8(torch, gen, (l, 3072), dev)
        t[l // 2 :: 9] = t[1]  # ties
        x[0] = t[1]
        s = torch.arange(0, 4096, 128, device=dev)
        bias = distance._k11_bias(distance._k11_dp(3072))
        want = distance._least(distance._keys(distance._l2_dense(x[s], t) - bias,
                                              torch.arange(l, device=dev)), 1024)
        before = L2_TOPCAP.launches
        with _no_fallback():
            with _uncertified() as unc:
                got = distance._l2_prefilter(x, t, 1024)
            ms = cuda_ms(torch, lambda: distance._l2_prefilter(x, t, 1024), reps=2)
        et.add(torch, got[s], (want & distance._MASK32).to(torch.int32),
               f"K11 prefilter 4096 x {l} x D=3072, k_pre 1024 (sampled)")
        check(L2_TOPCAP.launches > before, "the prefilter skipped K11")
        nr_rows[l] = {"plan": distance._k11_topcap_plan(l, 1024), "ms": ms,
                      "uncertified": unc["failed"]}
        log(f"K11 prefilter 4096 x {l} x D=3072, k_pre 1024, plan {nr_rows[l]['plan']}: "
            f"{ms:.3f} ms, {unc['failed']} rows failed the certificate (run again with whole "
            f"segments), plain versions refused; exact on a row sample [{card}]")
        del x, t, want, got

    def lib_argmin(xs, t):
        """The route K11's argmin replaces: f32 score stripes, first minimum."""
        xs_f, tf = xs.float(), t.float()
        norm = (tf * tf).sum(1)
        bc = max(1, distance._STRIPE_BYTES // (4 * t.shape[0]))
        out = torch.empty(xs.shape[0], dtype=torch.int64, device=dev)
        with distance._full_f32():
            for b0 in range(0, xs.shape[0], bc):
                out[b0 : b0 + bc] = (norm[None, :] - 2.0 * (xs_f[b0 : b0 + bc] @ tf.T)).argmin(1)
        return out

    def lib_topcap(xs, t, cap, seg):
        """The stripe and selection K11's top-cap replaces: f32 score
        stripes, packed keys of their order image, `_least` per segment."""
        xs_f, tf = xs.float(), t.float()
        norm = (tf * tf).sum(1)
        l = t.shape[0]
        nseg = -(-l // seg)
        cols = torch.arange(nseg * seg, device=dev)
        bc = max(1, distance._STRIPE_BYTES // (8 * nseg * seg))
        out = torch.empty((xs.shape[0], nseg, cap), dtype=torch.int64, device=dev)
        with distance._full_f32():
            for b0 in range(0, xs.shape[0], bc):
                bits = (norm[None, :] - 2.0 * (xs_f[b0 : b0 + bc] @ tf.T)).view(torch.int32)
                order = torch.nn.functional.pad(bits ^ ((bits >> 31) & distance.I32_MAX),
                                                (0, nseg * seg - l), value=distance.I32_MAX)
                out[b0 : b0 + bc] = distance._least(
                    distance._keys(order, cols).view(-1, nseg, seg), cap)
        return out

    res = {}
    for key, (b, l, d), k_pre in (("mode4", mode4, 64), ("flagship", flag, 1024)):
        x, t = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
        t[7] = t[l // 2]  # a tie
        x[0] = t[l // 2]
        seg, cap = distance._k11_topcap_plan(l, k_pre)
        prep = distance._k11_lib(t)
        s = torch.arange(0, b, 64 if key == "mode4" else 16, device=dev)
        dd, rr = distance._l2_argmin(x, t)
        wd, wr = distance._l2_argmin_ref(x[s], t)
        ea.add(torch, dd[s], wd, f"K11 argmin {key} {b} x {l} x D={d} (sampled)")
        ea.add(torch, rr[s], wr, f"K11 argmin {key} rows (sampled)")
        check(int(rr[0]) == 7 and int(dd[0]) == 0, "K11 argmin: the lowest of two equal rows")
        keys = distance.l2_topcap(x, t, cap, seg=seg, prepared=prep)
        s2 = s[:: 4 if key == "mode4" else 1]
        et.add(torch, keys[s2], distance._l2_topcap_ref(x[s2], t, cap, seg, 0, l),
               f"K11 top-cap {key} seg {seg} cap {cap} (sampled)")
        nseg = -(-l // seg)
        ms_a = cuda_ms(torch, lambda: distance._l2_argmin(x, t))
        ms_t = cuda_ms(torch, lambda: distance.l2_topcap(x, t, cap, seg=seg, prepared=prep), reps=3)
        res[key] = {"shape": f"{b} x {l} x D={d}", "seg": seg, "cap": cap,
                    "argmin_ms": ms_a, "topcap_ms": ms_t,
                    "argmin_bound_ms": bound(b * d + l * d + 8 * b, 2.0 * b * l * d)["bound_ms"],
                    "topcap_bound_ms": bound(b * d + l * d + 8 * b * nseg * cap,
                                             2.0 * b * l * d)["bound_ms"]}
        log(f"K11 {key} {b} x {l} x D={d}: argmin {ms_a:.3f} ms (bound "
            f"{res[key]['argmin_bound_ms']:.3f}), top-cap seg {seg} cap {cap} {ms_t:.3f} ms "
            f"(bound {res[key]['topcap_bound_ms']:.3f}); exact on a row sample [{card}]")
        if key == "mode4":  # the timed slice: kernel, plain version, library, bound
            xs = x[:rows_t].contiguous()
            check(torch.equal(lib_argmin(xs, t), distance._l2_argmin(xs, t)[1].long()),
                  "the f32 route's argmin != K11's at D = 48")
            tl = {"a": cuda_ms(torch, lambda: distance._l2_argmin(xs, t)),
                  "a_plain": cuda_ms(torch, lambda: distance._l2_argmin_ref(xs, t), reps=1),
                  "a_lib": cuda_ms(torch, lambda: lib_argmin(xs, t), reps=2),
                  "t": cuda_ms(torch, lambda: distance.l2_topcap(xs, t, cap, seg=seg,
                                                                 prepared=prep)),
                  "t_plain": cuda_ms(torch, lambda: distance._l2_topcap_ref(
                      xs, t, cap, seg, 0, l), reps=1),
                  "t_lib": cuda_ms(torch, lambda: lib_topcap(xs, t, cap, seg), reps=2)}
            slice_shape = f"{rows_t} x {l} x D={d}"
            nb_a = rows_t * d + l * d + 8 * rows_t
            nb_t = rows_t * d + l * d + 8 * rows_t * nseg * cap
            argmin_row = {"ms": tl["a"], "plain_ms": tl["a_plain"], "library_ms": tl["a_lib"],
                          **bound(nb_a, 2.0 * rows_t * l * d), "shape": slice_shape}
            topcap_row = {"ms": tl["t"], "plain_ms": tl["t_plain"], "library_ms": tl["t_lib"],
                          **bound(nb_t, 2.0 * rows_t * l * d),
                          "shape": f"{slice_shape}, seg {seg} cap {cap}"}
            log(f"K11 argmin {slice_shape}: kernel {tl['a']:.3f} ms, bound "
                f"{argmin_row['bound_ms']:.3f} ms ({argmin_row['bound_by']}); plain "
                f"{tl['a_plain']:.3f} ms; f32 matmul + argmin {tl['a_lib']:.3f} ms [{card}]")
            log(f"K11 top-cap {slice_shape} seg {seg} cap {cap}: kernel {tl['t']:.3f} ms, bound "
                f"{topcap_row['bound_ms']:.3f} ms ({topcap_row['bound_by']}); plain "
                f"{tl['t_plain']:.3f} ms; f32 matmul + packed keys + torch.topk a segment "
                f"{tl['t_lib']:.3f} ms [{card}]")
            del xs
        del x, t, prep, keys, dd, rr
        torch.cuda.empty_cache()
    for row, name in ((argmin_row, "argmin"), (topcap_row, "topcap")):
        for key in ("mode4", "flagship"):
            row[f"ms_{key}"] = res[key][f"{name}_ms"]
            row[f"bound_ms_{key}"] = res[key][f"{name}_bound_ms"]
            row[f"shape_{key}"] = res[key]["shape"] + (
                f", seg {res[key]['seg']} cap {res[key]['cap']}" if name == "topcap" else "")
    argmin_row["max_abs_err"], topcap_row["max_abs_err"] = ea.max, et.max
    topcap_row["prefilter_past_fast_plans"] = nr_rows
    return argmin_row, topcap_row


def phase_c_k5(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.ops import composite_lab as lab

    err = Err()
    seed = _u8(torch, gen, (8, 128), dev)
    shapes = [(1, 16), (7, 13), (24, 6144), (1024, 393216)]
    for h, w in shapes:
        err.add(torch, lab.floor_write(seed, h, w), lab.floor_write_ref(seed, h, w),
                f"K5 {h}x{w}")
    h, w = 1100, 4_000_000  # 4.4 GB, one call
    got = lab.floor_write(seed, h, w)
    err.add(torch, got, lab.floor_write_ref(seed, h, w), "K5 past 4 GiB")
    log(f"K5 bands {shapes} and {h}x{w} ({h * w / 2**30:.2f} GiB, one call): exact")
    del got
    torch.cuda.empty_cache()
    # the BASELINE band, the TPU tool's shape
    h, w = 1024, 393216
    ms = cuda_ms(torch, lambda: lab.floor_write(seed, h, w))
    plain_ms = cuda_ms(torch, lambda: lab.floor_write_ref(seed, h, w))
    filled = torch.empty((h, w), dtype=torch.uint8, device=dev)
    lib_ms = cuda_ms(torch, lambda: filled.fill_(seed[0, 0]))
    log(f"K5 {h}x{w} ({h * w / 1e6:.2f} MB): kernel {ms:.4f} ms ({h * w / ms / 1e6:.0f} "
        f"GB/s), plain {plain_ms:.4f} ms, fill_ {lib_ms:.4f} ms [{card}]")
    del filled
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms, **bound(h * w + 1, 0),
            "library_ms": lib_ms, "shape": f"[{h}, {w}] u8 band (the BASELINE band)"}


def phase_c_k6_k7(torch, gen, dev, card) -> tuple[dict, dict]:
    """K6 and K7 against their plain version (K2's), at ts 8..64 and nbx
    77..4096 with edge items, at the BASELINE band, and past 4 GiB."""
    from emosaic_tpu_torch.ops import composite
    from emosaic_tpu_torch.ops import composite_lab as lab

    errs = {1: Err(), 2: Err()}

    def both(items, aug, what, **kw):
        want = lab.compose_rows_bulk_ref(items, aug)
        for stages, err in errs.items():
            got = lab.compose_rows_bulk(items, aug, stages=stages, **kw)
            err.add(torch, got, want, f"{what} stages={stages}")

    tss, nbxs = (8, 16, 32, 64), (77, 128, 300, 4096)
    for ts in tss:
        t = 300
        aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
        for nbx in nbxs:
            both(edge_items(torch, gen, dev, t, 2, nbx), aug, f"K6/K7 ts={ts} nbx={nbx}")
        both(edge_items(torch, gen, dev, t, 3, 77), aug, f"K6/K7 ts={ts} run=1", run=1)
    log(f"K6, K7 ts {tss} x nbx {nbxs} (and run 1), items 0, +-T, out of range, "
        "+-(2^31 - 1 or 2^31): exact")
    # the BASELINE band: 32 block-rows x 4096 tiles, ts = 32, T = 100k
    t, ts = 100000, 32
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    items = edge_items(torch, gen, dev, t, 32, 4096)
    both(items, aug, "K6/K7 BASELINE band")
    ms = {s: cuda_ms(torch, lambda: lab.compose_rows_bulk(items, aug, stages=s))
          for s in (1, 2)}
    plain_ms = cuda_ms(torch, lambda: lab.compose_rows_bulk_ref(items, aug))
    bound_band = k2_bound(torch, items, aug)
    band = items.numel() * ts * ts * 3
    log(f"K6 / K7 BASELINE band {band / 1e6:.1f} MB at run {lab.RUN}: {ms[1]:.3f} / "
        f"{ms[2]:.3f} ms ({2 * band / ms[1] / 1e6:.0f} / {2 * band / ms[2] / 1e6:.0f} GB/s "
        f"moved), plain {plain_ms:.3f} ms [{card}]")
    del aug
    torch.cuda.empty_cache()
    # a 9.8 GB stack (T = 100k, ts = 128), items aimed past 4 GiB
    t, ts = 100000, 128
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    first_far = (1 << 32) // (ts * ts * 3) + 1
    far = torch.randint(first_far + 1, t + 1, (2, 512), dtype=torch.int32, device=dev,
                        generator=gen)
    far[1] = -far[1]
    both(far, aug, "K6/K7 9.8 GB stack")
    log(f"K6, K7 stack {aug.numel() / 1e9:.2f} GB, items at rows >= {first_far} (byte "
        f"offset > 4 GiB), runs of {min(lab.RUN, lab.run_fit(ts, 1))} and "
        f"{min(lab.RUN, lab.run_fit(ts, 2))} tiles: exact")
    del aug
    torch.cuda.empty_cache()
    rows = []
    for stages in (1, 2):
        rows.append({"max_abs_err": errs[stages].max, "ms": ms[stages],
                     "plain_ms": plain_ms, **bound_band, "library_ms": None,
                     "shape": f"items [32, 4096], T=100000, ts=32, stages={stages}, "
                              f"run={lab.RUN}"})
    return rows[0], rows[1]


def phase_c_k8(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.ops import composite
    from emosaic_tpu_torch.ops import composite_lab as lab
    from emosaic_tpu_torch.probes import composite_variants as cv

    err = Err()
    tss, nbxs = (8, 16, 32, 64), (77, 128, 300, 4096)
    for ts in tss:
        for nbx in nbxs:
            sel = _u8(torch, gen, (2 * nbx, ts, ts * 3), dev)
            err.add(torch, lab.band_transpose(sel, 2, nbx), lab.band_transpose_ref(sel, 2, nbx),
                    f"K8 ts={ts} nbx={nbx}")
    log(f"K8 ts {tss} x nbx {nbxs}: exact")
    # the TPU tool's shape: 128 x 4096 tiles of ts = 32 gathered from 100k
    t, ts, nby, nbx = 100000, 32, 128, 4096
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    items = torch.randint(1, t + 1, (nby, nbx), dtype=torch.int32, device=dev, generator=gen)
    sel = cv.gather(items, aug)
    del aug
    got = lab.band_transpose(sel, nby, nbx)
    err.add(torch, got, lab.band_transpose_ref(sel, nby, nbx), "K8 at the tool's shape")
    del got
    ms = cuda_ms(torch, lambda: lab.band_transpose(sel, nby, nbx))
    plain_ms = cuda_ms(torch, lambda: lab.band_transpose_ref(sel, nby, nbx))
    lib_ms = cuda_ms(torch, lambda: cv.relayout_copy(sel, nby, nbx))
    i32_ms = cuda_ms(torch, lambda: cv.relayout_copy_i32(sel, nby, nbx))
    nb = 2 * sel.numel()
    log(f"K8 [{nby * nbx}, {ts}, {ts * 3}] -> [{nby * ts}, {nbx * ts * 3}] "
        f"({sel.numel() / 1e9:.2f} GB): kernel {ms:.3f} ms ({nb / ms / 1e6:.0f} GB/s moved), "
        f"plain {plain_ms:.3f} ms, copy_ {lib_ms:.3f} ms, copy_ on int32 (v4) "
        f"{i32_ms:.3f} ms [{card}]")
    del sel
    torch.cuda.empty_cache()
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms, **bound(nb, 0),
            "library_ms": lib_ms, "library_i32_ms": i32_ms,
            "shape": f"sel [{nby * nbx}, {ts}, {ts * 3}] u8 (the tool's 1.61 GB band)"}


def phase_c_tint_lut(torch, gen, dev, card) -> None:
    from emosaic_tpu_torch.ops import composite, distance, lut

    m = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None], (256, 256, 3))
    s = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None], (256, 256, 3))
    bad = 0
    for alpha in range(256):
        got = composite.tint_blend(m, s, (alpha + 0.5) / 255.0, device=dev)
        bad += int((got != composite.ref_tint_blend_u8(m, s, alpha)).sum())
    check(bad == 0, f"tint on the card: {bad} mismatches")
    log("tint: 256 alphas x 65536 pairs on the card, 0 mismatches")
    base = np.random.default_rng(SEED).integers(0, 256, (30000, 3), dtype=np.uint8)
    lib = np.concatenate([base, base[::3]])  # duplicate colours: lowest row
    t0 = time.perf_counter()
    on_card = lut.build_l1_lut(lib, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    on_cpu = lut.build_l1_lut(lib, device="cpu")
    t2 = time.perf_counter()
    check(torch.equal(on_card.cpu(), on_cpu), "LUT: card and CPU tables differ")
    q = _u8(torch, gen, (4096, 3), dev)
    d, r = lut.lut_match(q, on_card)
    wd, wr = distance.l1_argmin_ref(q, torch.as_tensor(lib, device=dev))
    check(torch.equal(d, wd) and torch.equal(r, wr), "LUT match != plain argmin")
    log(f"LUT: card table == CPU table, all 16.7M entries; build card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s [{card}]")


def _no_fallback(lab: bool = False):
    """Context: make the plain versions of the main path's kernels raise
    (with `lab`, those of the composite lab kernels K5 to K8), so a run
    that completes went through the kernels."""
    import contextlib

    from emosaic_tpu_torch.ops import composite, composite_lab, distance

    if lab:
        names = [(composite_lab, n) for n in
                 ("floor_write_ref", "compose_rows_bulk_ref", "band_transpose_ref")]
    else:
        names = [(distance, "l1_argmin_ref"), (composite, "compose_rows_ref"),
                 (distance, "_l1_rows_ref"), (distance, "_seg_topcap_ref"),
                 (distance, "_coarse_topcap_ref"), (distance, "_l1_block_ref"),
                 (distance, "_l1_topcap_ref"), (distance, "_l2_argmin_ref"),
                 (distance, "_l2_topcap_ref"), (distance, "_l2_dense"),
                 (distance, "_row_sort_ref")]

    @contextlib.contextmanager
    def ctx():
        saved = [getattr(mod, name) for mod, name in names]

        def refuse(*a, **k):
            raise AssertionError("a CUDA tensor reached a plain version")

        for mod, name in names:
            setattr(mod, name, refuse)
        try:
            yield
        finally:
            for (mod, name), fn in zip(names, saved):
                setattr(mod, name, fn)

    return ctx()


def _uncertified():
    """Context: count the rows of the hybrid prefilter's first pass
    ("rows") and those that fail its certificate (`distance._l2_least`'s
    ok) and so run again with whole segments ("failed"), in the dict it
    yields."""
    import contextlib

    from emosaic_tpu_torch.ops import distance

    @contextlib.contextmanager
    def ctx():
        real, tally = distance._l2_least, {"rows": 0, "failed": 0}

        def counted(x, t, k_pre, seg, cap, prepared):
            rows, ok = real(x, t, k_pre, seg, cap, prepared)
            if cap < seg:  # not the rerun, whose segments are whole
                tally["rows"] += x.shape[0]
                tally["failed"] += int((~ok).sum())
            return rows, ok

        distance._l2_least = counted
        try:
            yield tally
        finally:
            distance._l2_least = real

    return ctx()


def phase_c_no_fallback(torch, gen, dev) -> None:
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.ops.analysis import analyse_batch
    from emosaic_tpu_torch.render.matched import match_blocks, render_nto1
    from emosaic_tpu_torch.tiles.tileset import TileSet

    stack = _u8(torch, gen, (300, 16, 16, 3), dev)
    pal = analyse_batch(stack, 4, device=dev).cpu().numpy()
    ts = TileSet.from_arrays(pal, [f"t{i}.jpg" for i in range(300)])
    src = np.random.default_rng(SEED).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    with _no_fallback():
        res = render_nto1(src, ts, 16, device=dev, stack=stack)
    cpu = render_nto1(src, ts, 16, device="cpu", stack=stack.cpu().numpy())
    check(np.array_equal(res.image, cpu.image), "no-fallback run != CPU run")
    # the dedup route: few unique blocks among > 8192
    blocks = _u8(torch, gen, (100, 48), dev)[
        torch.randint(0, 100, (20000,), device=dev, generator=gen)]
    lib = _u8(torch, gen, (600, 48), dev)
    with _no_fallback():
        d, r = match_blocks(blocks, lib)
    wd, wr = distance.l1_argmin_ref(blocks, lib)
    check(np.array_equal(d, wd.cpu().numpy()) and np.array_equal(r, wr.cpu().numpy()),
          "dedup route != plain argmin")
    # the no-repeat render on its adaptive route (K3), 8400 library rows
    from emosaic_tpu_torch.render import norepeat

    t = 4200
    base = torch.randint(0, 256, (t // 8, 1, 3), device=dev, generator=gen)
    pal = (base.repeat_interleave(8, 0).int()
           + torch.randint(-10, 11, (t, 16, 3), device=dev, generator=gen)).clamp(0, 255)
    pal = pal.to(torch.uint8).cpu().numpy()
    ts = TileSet.from_arrays(pal, [f"t{i}.jpg" for i in range(t)])
    rng = np.random.default_rng(SEED)
    blk = pal[rng.integers(0, t, 192)].astype(np.int32) + rng.integers(-6, 7, (192, 16, 3))
    src = np.clip(blk, 0, 255).astype(np.uint8).reshape(12, 16, 4, 4, 3)
    src = src.transpose(0, 2, 1, 3, 4).reshape(48, 64, 3)  # 12 x 16 blocks of 4 x 4
    stack = _u8(torch, gen, (t, 8, 8, 3), dev)
    saved = norepeat._EXACT_BUDGET
    norepeat._EXACT_BUDGET = 0  # take the adaptive route at this size
    try:
        with _no_fallback():
            res = norepeat.render_nto1_no_repeat(src, ts, 8, device=dev, stack=stack,
                                                 log=lambda *a: None)
        cpu = norepeat.render_nto1_no_repeat(src, ts, 8, device="cpu",
                                             stack=stack.cpu().numpy(), log=lambda *a: None)
    finally:
        norepeat._EXACT_BUDGET = saved
    check(res.info["scoring"]["route"] == "adaptive", f"route {res.info['scoring']}")
    check(np.array_equal(res.image, cpu.image), "no-repeat no-fallback run != CPU run")
    # K10: the two-level scorer (the fused entry, then the stripe fallback
    # for a run of near-equal rows in one segment), the stripes and the
    # dense matrix on u8 rows, with torch.cdist raising too
    lib = rng.integers(0, 256, size=(3000, 48), dtype=np.uint8)
    near = lambda n: np.clip(lib[0] + rng.integers(-2, 3, (n, 48)), 0, 255)  # noqa: E731
    lib[1100:1140] = near(40)
    blk = rng.integers(0, 256, size=(200, 48), dtype=np.uint8)
    blk[:50] = near(50)
    runs = [lambda dv: distance.l1_topk_twolevel(blk, lib, 16, device=dv),
            lambda dv: distance.l1_topk_stripes(blk, lib, 16, device=dv),
            lambda dv: (distance.l1_dist_matrix(blk, lib, device=dv),)]
    cdist = torch.cdist

    def no_cdist(*a, **k):
        raise AssertionError("a u8 stripe reached torch.cdist")

    torch.cdist = no_cdist
    try:
        with _no_fallback():
            got = [run(dev) for run in runs]
    finally:
        torch.cdist = cdist
    for g, run in zip(got, runs):
        check(all(np.array_equal(a, b) for a, b in zip(g, run("cpu"))),
              "a K10 route != the CPU run")
    log("no fallback: render_nto1 (mode 4, composite), the dedup route, the "
        "adaptive no-repeat render (K9, K3) and the two-level scorer, the stripes and "
        "the dense matrix (K10, with torch.cdist raising too) ran with every plain "
        "version raising; equal to the CPU runs")


# ---------------------------------------------------------------------------
# D
# ---------------------------------------------------------------------------


def synthetic_photo(torch, h, w, gen, dev) -> np.ndarray:
    """A smooth colour field with fine noise: a stand-in photo whose blocks
    are mostly distinct."""
    y = torch.linspace(0, 1, h, device=dev)[:, None]
    x = torch.linspace(0, 1, w, device=dev)[None, :]
    r = 127.5 + 127.5 * torch.sin(6.2832 * (1.3 * x + 0.7 * y))
    g = 255.0 * y * torch.ones_like(x)
    b = 255.0 * x * (1 - y) + 60.0 * torch.cos(9.0 * x * y)
    img = torch.stack([r, g, b], -1)
    img = img + 6.0 * torch.randn(img.shape, device=dev, generator=gen)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def synthetic_tiles(torch, t, ts, gen, dev):
    """t tiles, each a random base colour plus noise (the verify recipe)."""
    base = torch.randint(0, 256, (t, 1, 1, 3), device=dev, generator=gen).float()
    noise = 30.0 * torch.randn((t, ts, ts, 3), device=dev, generator=gen)
    return (base + noise).clamp(0, 255).to(torch.uint8)


def png_rows(path: Path, rows) -> tuple[int, int, dict]:
    """Parse a PNG written by StreamingPNGWriter (CRCs checked) and return
    (width, height, {row: [W*3] u8}) for the asked rows."""
    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, idat, w, h = 8, [], 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos : pos + 4])[0]
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0]
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"PNG {tag} CRC")
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    check(raw.size == h * (1 + w * 3), "PNG data size")
    raw = raw.reshape(h, 1 + w * 3)
    out = {}
    for y in rows:
        ftype, f = int(raw[y, 0]), raw[y, 1:]
        check(ftype in (0, 1), f"PNG filter {ftype}")
        if ftype == 1:  # Sub: running sum per channel, mod 256
            f = (np.cumsum(f.reshape(w, 3).astype(np.int64), axis=0) % 256)
            f = f.astype(np.uint8).reshape(-1)
        out[y] = f
    return w, h, out


def expected_row(items, stack_host, y, ts):
    """Host composite of output row y from the items grid and the stack."""
    by, r = divmod(y, ts)
    parts = []
    for it in items[by]:
        if it == 0:
            parts.append(np.zeros((ts, 3), np.uint8))
        else:
            tile = stack_host[abs(int(it)) - 1]
            parts.append(tile[r, ::-1] if it < 0 else tile[r])
    return np.concatenate(parts).reshape(-1)


def phase_d(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.io.codecs import StreamingPNGWriter
    from emosaic_tpu_torch.ops import composite, distance
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.ops.analysis import analyse_batch, source_blocks
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.tiles.tileset import TileSet

    times = {}
    t_tiles = 100000
    paths = [f"synthetic/{i:06d}.jpg" for i in range(t_tiles)]
    t0 = time.perf_counter()
    stack32 = synthetic_tiles(torch, t_tiles, 32, gen, dev)
    stack16 = torch.nn.functional.avg_pool2d(
        stack32.permute(0, 3, 1, 2).float(), 2).permute(0, 2, 3, 1).to(torch.uint8).contiguous()
    src1 = synthetic_photo(torch, 4096, 4096, gen, dev)
    src4 = synthetic_photo(torch, 2048, 2048, gen, dev)
    torch.cuda.synchronize()
    times["set-up: 100k synthetic tiles + sources"] = time.perf_counter() - t0
    out_png = WORK / "mode4_tinted.png"
    WORK.mkdir(parents=True, exist_ok=True)

    for k in KERNELS:
        k.launches = 0
    t_main = time.perf_counter()
    with _no_fallback():
        t0 = time.perf_counter()
        pal1 = analyse_batch(stack32, 1, device=dev).cpu().numpy()
        pal4 = analyse_batch(stack16, 4, device=dev).cpu().numpy()
        times["analyse_batch 100k tiles (dims 1 and 4)"] = time.perf_counter() - t0
        ts1 = TileSet.from_arrays(pal1, paths)
        ts4 = TileSet.from_arrays(pal4, paths)
        t0 = time.perf_counter()
        res1 = render_nto1(src1, ts1, 32, device=dev, compose=False)
        times["mode 1 4096^2 match (LUT, 16.7M blocks)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bands = list(itertools.islice(
            composite.iter_bands(res1.items, stack32, 8, device=dev), 2))
        times["mode 1 two bands via iter_bands (2 x 100.7 MB)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res4 = render_nto1(src4, ts4, 16, device=dev, compose=False)
        times["mode 4 2048^2 match (K1, 262144 blocks x 200k rows)"] = (
            time.perf_counter() - t0)
        t0 = time.perf_counter()
        with StreamingPNGWriter(out_png, 8192, 8192) as w:
            for band in composite.stream_tinted_bands(
                res4.items, ts4, stack16, 16, original_rgb=src4, tint_opacity=0.3,
                device=dev,
            ):
                w.write_band(band)
        times["mode 4 8192^2 composite + tint 0.3 + PNG stream"] = (
            time.perf_counter() - t0)
    times["main path total"] = time.perf_counter() - t_main
    launches = {k.name: k.launches for k in KERNELS}
    for name, secs in times.items():
        log(f"D {name}: {secs:.3f} s [{card}]")
    log(f"D launches in the main path's run: {launches}")

    # outputs: the mode-1 items equal the same call on the CPU
    t0 = time.perf_counter()
    cpu1 = render_nto1(src1, ts1, 32, device="cpu", compose=False)
    check(np.array_equal(res1.items, cpu1.items), "mode 1 items: card != CPU")
    log(f"mode 1 items grid {res1.items.shape} == CPU run "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")
    stack32_h = stack32.cpu().numpy()
    for i, band in enumerate(bands):
        check(band.shape == (256, 4096 * 32, 3), f"band shape {band.shape}")
        flat = band.reshape(256, -1)
        for y in (0, 37, 255):
            want = expected_row(res1.items, stack32_h, i * 256 + y, 32)
            check(np.array_equal(flat[y], want), f"mode 1 band {i} row {y}")
    log("mode 1 bands: rows equal the host composite of the items grid")
    # mode 4: K1's choice on a block sample equals the plain argmin
    blocks4 = source_blocks(src4, 4, device=dev)
    lib4 = distance.build_library(torch.as_tensor(pal4, device=dev))
    sample = np.arange(0, blocks4.shape[0], blocks4.shape[0] // 4096)
    wd, wr = distance.l1_argmin_ref(blocks4[torch.as_tensor(sample, device=dev)], lib4)
    got = distance.rows_to_items(wr.cpu(), t_tiles).numpy()
    check(np.array_equal(res4.items.reshape(-1)[sample], got), "mode 4 items != plain")
    check(np.array_equal(res4.stats._get_arrays()[3][sample], wd.cpu().numpy()),
          "mode 4 distances != plain")
    # mode 4 PNG: sampled rows equal the host composite + reference tint
    stack16_h = stack16.cpu().numpy()
    rows = [0, 1, 15, 16, 4095, 4096, 8191]
    w, h, got_rows = png_rows(out_png, rows)
    check((w, h) == (8192, 8192), f"PNG size {w}x{h}")
    alpha = int(255.0 * 0.3)
    for y in rows:
        mosaic = expected_row(res4.items, stack16_h, y, 16)
        yi, xi3 = composite._tint_sample_indices(1, 8192, 2048, 2048, 8192, y)
        fg = src4.reshape(2048, -1)[yi][:, xi3][0]
        want = composite.ref_tint_blend_u8(mosaic, fg, alpha)
        check(np.array_equal(got_rows[y], want), f"mode 4 PNG row {y}")
    log(f"mode 4: items equal the plain argmin on {sample.size} blocks; PNG "
        f"{out_png.stat().st_size / 1e6:.1f} MB, rows {rows} equal the reference "
        "composite + tint")
    out_png.unlink()
    # phase P's inputs, on the host: the two libraries' palettes, the
    # mode-4 tiles and source, and the mode-4 items
    return {"launches": launches, "pal1": pal1, "pal4": pal4, "stack16": stack16_h,
            "src4": src4, "items4": res4.items}


# ---------------------------------------------------------------------------
# N
# ---------------------------------------------------------------------------


def clustered_palettes(torch, t, n_cells, gen, dev):
    """t palettes [t, n_cells, 3] u8, each a random base colour with +-10
    texture per cell (the JAX package's bench model of a real library)."""
    base = torch.randint(0, 256, (t, 1, 3), device=dev, generator=gen)
    tex = torch.randint(-10, 11, (t, n_cells, 3), device=dev, generator=gen)
    return (base + tex).clamp(0, 255).to(torch.uint8)


def blocks_of(torch, pal, nb, gen, dev):
    """nb blocks [nb, n_cells, 3] u8: palettes picked at random, +-6 noise."""
    pick = torch.randint(0, pal.shape[0], (nb,), device=dev, generator=gen)
    noise = torch.randint(-6, 7, (nb,) + tuple(pal.shape[1:]), device=dev, generator=gen)
    return (pal[pick].int() + noise).clamp(0, 255).to(torch.uint8)


def profile_render(torch, run, card) -> None:
    """One more run of `run` under torch.profiler: the device's busy share
    of the wall (the kernels' device time over the host clock) and the
    five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("N profile: the profiler saw no device time (not measured)")
        return
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:  # the union of the device intervals
        busy_us += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    busy = busy_us / 1e6
    top = "; ".join(f"{k[:48]} {us / 1e3:.1f} ms"
                    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    log(f"N profile of one more render: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%; top: {top} [{card}]")


#: the reference Makefile's default class: mode 32, --no-repeat, a 4096^2
#: source, T = 32767 tiles (its cap) -> B = 16384, L = 65534, D = 3072
FLAGSHIP_DIM = 32


def flagship_scene(torch, gen, dev, t=32767, side=4096):
    """(palettes [t, 1024, 3] on the card, the source [side, side, 3] host
    u8, its TileSet, the stack [t, 32, 32, 3] on the card): block (by, bx)
    of the source is a noisy copy of a random palette laid out as 32x32
    pixels, and each tile image is its palette."""
    from emosaic_tpu_torch.tiles.tileset import TileSet

    dim = FLAGSHIP_DIM
    g = side // dim
    pal = clustered_palettes(torch, t, dim * dim, gen, dev)
    blk = blocks_of(torch, pal, g * g, gen, dev)
    src = blk.view(g, g, dim, dim, 3).permute(0, 2, 1, 3, 4).reshape(side, side, 3)
    src = src.cpu().numpy()
    ts = TileSet.from_arrays(pal.cpu().numpy(), [f"synthetic/{i:05d}.jpg" for i in range(t)])
    torch.cuda.synchronize()
    return pal, src, ts, pal.view(t, dim, dim, 3)


def phase_n(torch, gen, dev, card, t=32767, side=4096, t2=16384) -> dict:
    from emosaic_tpu_torch import native
    from emosaic_tpu_torch.ops import distance, refill
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.ops.analysis import source_blocks
    from emosaic_tpu_torch.probes.k1_k3 import reuse
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat

    dim, k = FLAGSHIP_DIM, 512
    g = side // dim
    t0 = time.perf_counter()
    pal, src, ts, stack = flagship_scene(torch, gen, dev, t, side)
    log(f"N set-up: {t} clustered tiles and a {side}^2 source in "
        f"{time.perf_counter() - t0:.3f} s")

    for kern in KERNELS:
        kern.launches = 0
    lines = []
    t0 = time.perf_counter()
    with _no_fallback():
        res = render_nto1_no_repeat(src, ts, dim, device=dev, stack=stack, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in KERNELS}
    info, sc = res.info, res.info["scoring"]
    sp = {name: e["s"] for name, e in info["spans"].items()}
    for ln in lines:
        log(f"N {ln.strip()}")
    log(f"N render_nto1_no_repeat: {wall:.3f} s; scoring {info['scoring_s']:.3f} s "
        f"(prepare {sp['scoring.prepare']:.3f}, coarse {sp['scoring.coarse']:.3f}, rescore "
        f"{sp['scoring.rescore']:.3f}, fallback {sp['scoring.fallback']:.3f} for "
        f"{sc['fallback']} rows, audit {sp['scoring.audit']:.3f}), assignment "
        f"{info['assign_s']:.3f} s ({info['engine']}, {info['refill_events']} device refill "
        f"events), stats + compose {sp['render.stats'] + sp['render.compose']:.3f} s "
        f"[{card}]")
    log(f"N launches in the no-repeat run: {launches}")
    check(info["scorer"] == "adaptive-exact", f"scorer {info['scorer']}")
    check(sc["route"] == "adaptive", f"adaptive route {sc['route']}")
    log(f"N certified {sc['certified']}/{sc['blocks']} blocks; {sc['fallback']} "
        "took the stripe fallback")
    items = res.items.reshape(-1)
    check(bool((items != 0).all()), "a block was left unassigned")
    check(np.unique(np.abs(items)).size == items.size,
          "a tile was used twice, or with its mirror")
    check(res.image.shape == (side, side, 3), f"image {res.image.shape}")
    stack_h = stack.cpu().numpy()
    for y in (0, 31, side // 2, side - 1):
        check(np.array_equal(res.image[y].reshape(-1),
                             expected_row(res.items, stack_h, y, dim)), f"N image row {y}")
    log(f"N assignment: {items.size} blocks, every |item| distinct (no repeat, no "
        "mirror pair); image rows equal the host composite")
    profile_render(torch, lambda: render_nto1_no_repeat(
        src, ts, dim, device=dev, stack=stack, log=lambda *a: None), card)

    # the lists: the adaptive scorer against the independent two-level one;
    # K3's own inputs in that run are kept for its timing below
    blocks = source_blocks(src, dim, device=dev)
    lib = distance.build_library(pal)
    seen, l1_rows = [], distance.l1_rows
    distance.l1_rows = lambda x_, c_, t_: seen.append((x_, c_, t_)) or l1_rows(x_, c_, t_)
    t0 = time.perf_counter()
    try:
        da, ra = distance.l1_topk_adaptive(blocks, lib, k)
    finally:
        distance.l1_rows = l1_rows
    ad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dt, rt = distance.l1_topk_twolevel(blocks, lib, k)
    tl_s = time.perf_counter() - t0
    check(np.array_equal(da, dt) and np.array_equal(ra, rt),
          "adaptive lists != two-level lists")
    log(f"N [{blocks.shape[0]}, {k}] lists: adaptive == two-level, bit for bit "
        f"(adaptive {ad_s:.3f} s, two-level {tl_s:.3f} s) [{card}]")
    # K3 on the flagship's own candidate lists (the rescore's largest call)
    xx, cc, tt = max(seen, key=lambda s_: s_[1].numel())
    del seen
    s = torch.arange(0, xx.shape[0], 16, device=dev)
    got = distance.l1_rows(xx, cc, tt)
    Err().add(torch, got[s], distance._l1_rows_ref(xx[s], cc[s], tt),
              "K3 on the flagship's own lists (1/16 sample)")
    lists_ms = cuda_ms(torch, lambda: distance.l1_rows(xx, cc, tt))
    lists_reuse = reuse(torch, cc, minhash=True)
    lists_shape = list(cc.shape)
    log(f"N K3 on the flagship's own lists {lists_shape} (exact on a 1/16 sample): "
        f"{lists_ms:.3f} ms; reuse {lists_reuse:.3f} pairs per fetched row in groups of 16 "
        f"in min-hash order ({reuse(torch, cc):.3f} in consecutive groups) [{card}]")
    del xx, cc, tt, got, blocks

    # the worst case: uniform data of the same shape reroutes to two-level
    lib_u = torch.randint(0, 256, lib.shape, dtype=torch.uint8, device=dev, generator=gen)
    blocks_u = torch.randint(0, 256, (g * g, dim * dim * 3), dtype=torch.uint8,
                             device=dev, generator=gen)
    st = {}
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    with _no_fallback():
        du, ru = distance.l1_topk(blocks_u, lib_u, k, stats=st)
    worst_s = time.perf_counter() - t0
    launches_worst = {kern.name: kern.launches for kern in KERNELS}
    log(f"N launches in the worst case's run: {launches_worst}")
    check(st["route"] == "twolevel (sample gate)", f"worst-case route {st['route']}")
    sample = torch.arange(0, g * g, 257, device=dev)
    ds, rs = distance.l1_topk_stripes(blocks_u[sample], lib_u, k)
    idx = sample.cpu().numpy()
    check(np.array_equal(du[idx], ds) and np.array_equal(ru[idx], rs),
          "worst-case lists != stripes on a sample")
    fallback = launches_worst["l1_stripe"]
    log(f"N worst case (uniform data) through l1_topk: {worst_s:.3f} s, route "
        f"{st['route']} (K10's fused entry, then {fallback} stripe launches for the rows "
        f"that did not certify); a {idx.size}-block sample equals the stripes [{card}]")
    del lib_u, blocks_u, lib
    torch.cuda.empty_cache()

    # full library consumption (B = T): device refills against host scans
    pal2 = pal[:t2].contiguous()
    blocks2 = blocks_of(torch, pal2, t2, gen, dev).reshape(t2, -1)
    lib2 = distance.build_library(pal2)
    cd, cr = distance.l1_topk_adaptive(blocks2, lib2, k)
    bh, lh = blocks2.cpu().numpy(), lib2.cpu().numpy()
    refiller = refill.DeviceRefiller(blocks2, lib2)
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    r_dev, d_dev = native.greedy_global(cd, cr, bh, lh, t2, refill_cb=refiller,
                                        cb_max_batch=refiller.max_batch)
    dev_s = time.perf_counter() - t0
    launches_consume = {kern.name: kern.launches for kern in KERNELS}
    t0 = time.perf_counter()
    r_host, d_host = native.greedy_global(cd, cr, bh, lh, t2)
    host_s = time.perf_counter() - t0
    check(refiller.n_calls > 0, "the device refiller was never called")
    check(np.array_equal(r_dev, r_host) and np.array_equal(d_dev, d_host),
          "device-refill assignment != host-scan assignment")
    check(int((r_host >= 0).sum()) == t2, "the library was not fully consumed")
    log(f"N full consumption, B = T = {t2}, L = {2 * t2}: device refills "
        f"{dev_s:.3f} s ({refiller.n_calls} events, {refiller.n_fused} on K12, "
        f"{refiller.n_blocks} blocks), host scans {host_s:.3f} s; rows and dists identical "
        f"[{card}]")

    # the render entry on traffic that refills: the same scene through
    # render_nto1_no_repeat, its first `flat` blocks one colour (a sky or a
    # plain background), whose candidate lists run dry together, so the
    # engine sends batches of hundreds of blocks besides single ones;
    # against the same render on the engine's host scans
    from emosaic_tpu_torch.tiles.tileset import TileSet

    g2, flat = int(round(t2 ** 0.5)), 1024
    sky = blocks2.clone()
    sky[:flat] = sky[0]
    src2 = (sky.view(g2, g2, dim, dim, 3).permute(0, 2, 1, 3, 4)
            .reshape(g2 * dim, g2 * dim, 3).cpu().numpy())
    ts2 = TileSet.from_arrays(pal2.cpu().numpy(), [f"synthetic/{i:05d}.jpg" for i in range(t2)])
    stack2 = pal2.view(t2, dim, dim, 3)
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    res2 = render_nto1_no_repeat(src2, ts2, dim, device=dev, stack=stack2, log=lambda *a: None)
    torch.cuda.synchronize()
    refill_wall = time.perf_counter() - t0
    launches_refill = {kern.name: kern.launches for kern in KERNELS}
    info2 = res2.info
    # the same render on the engine's host scans: the device refill's
    # threshold out of reach, so `refiller_for` gives no refiller
    keep = refill._DEVICE_REFILL_MIN_LD
    refill._DEVICE_REFILL_MIN_LD = float("inf")
    try:
        t0 = time.perf_counter()
        res3 = render_nto1_no_repeat(src2, ts2, dim, device=dev, stack=stack2,
                                     log=lambda *a: None)
        refill_host_wall = time.perf_counter() - t0
    finally:
        refill._DEVICE_REFILL_MIN_LD = keep
    big = info2["refill_events"] - info2["refill_fused_events"]
    log(f"N render_nto1_no_repeat on refilling traffic ({g2 * dim}^2, B = T = {t2}, the first "
        f"{flat} blocks flat): {refill_wall:.3f} s, assignment {info2['assign_s']:.3f} s; "
        f"{info2['refill_events']} device refill calls of {info2['refill_blocks']} blocks, "
        f"{info2['refill_fused_events']} on K12 and {big} above the crossover "
        f"(M > {refill._K12_MAX_M}) on K10's stripe; host scans "
        f"{info2['refill_host_events']}. On the engine's host scans: {refill_host_wall:.3f} s, "
        f"assignment {res3.info['assign_s']:.3f} s, {res3.info['refill_host_events']} scans "
        f"[{card}]")
    log(f"N launches in the refilling render: {launches_refill}")
    check(info2["refill_host_events"] == 0, "a refill event went to the host scan")
    check(np.array_equal(res2.items, res3.items), "device-refill render != host-scan render")
    check(np.array_equal(res2.image, res3.image), "device-refill image != host-scan image")
    log("N refilling render: items and image identical to the host scans' render")
    del pal, pal2, blocks2, lib2, stack, sky, stack2, res2, res3
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall, "certified": sc["certified"],
            "lists_adaptive_s": ad_s, "lists_twolevel_s": tl_s, "worst_s": worst_s,
            "launches_worst": launches_worst, "consume_device_s": dev_s,
            "consume_host_s": host_s, "consume_events": refiller.n_calls,
            "consume_fused": refiller.n_fused, "launches_consume": launches_consume,
            "launches_refill": launches_refill, "refill_render_s": refill_wall,
            "refill_render_host_s": refill_host_wall, "refill_calls": info2["refill_events"],
            "refill_fused": info2["refill_fused_events"],
            "k3_lists_ms": lists_ms, "k3_lists_reuse": lists_reuse,
            "k3_lists_shape": lists_shape}


# ---------------------------------------------------------------------------
# L, H
# ---------------------------------------------------------------------------


def phase_l(torch, dev, card) -> dict:
    """The lab probes: K4 and K9 in the coarse pass at the 200k shape, the
    device-memory accounting of the scorer at a 2M-row library, and the
    composite lab kernels K5 to K8 at the TPU tools' bands, with their
    plain versions raising; returns the probes' results and the launches
    of this path's run."""
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.probes import composite_variants, flatdma, r3_composite, seg8

    for k in KERNELS:
        k.launches = 0
    out = {}
    with _no_fallback(lab=True):
        for name, mod in (("seg8", seg8), ("flatdma", flatdma), ("r3", r3_composite),
                          ("variants", composite_variants)):
            log(f"-- L probes/{mod.__name__.rsplit('.', 1)[1]}.py")
            out[name] = mod.probe(dev, card)
            torch.cuda.empty_cache()
    out["launches"] = {k.name: k.launches for k in KERNELS}
    log(f"L launches in the lab probes' run: {out['launches']}")
    return out


def phase_h(torch, gen, dev, card, t_tiles=100000, side4=2048, t=32767, side_n=4096,
            side=256) -> dict:
    """This slice's paths at full width: the hybrid and the L2 matcher at
    phase D's mode-4 shape, the hybrid no-repeat scorer at the flagship
    shape, and random mode into an 8192^2 output, in memory and streamed."""
    from emosaic_tpu_torch.ops import composite, distance
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.ops.analysis import analyse_batch, source_blocks
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat
    from emosaic_tpu_torch.render.random_mode import random_items, render_random
    from emosaic_tpu_torch.tiles.tileset import TileSet

    t0 = time.perf_counter()
    stack16 = synthetic_tiles(torch, t_tiles, 16, gen, dev)
    pal4 = analyse_batch(stack16, 4, device=dev).cpu().numpy()
    ts4 = TileSet.from_arrays(pal4, [f"synthetic/{i:06d}.jpg" for i in range(t_tiles)])
    src4 = synthetic_photo(torch, side4, side4, gen, dev)
    pal, src, ts, stack = flagship_scene(torch, gen, dev, t, side_n)
    t_rand, ts_rand = 1000, 32
    stack_r = _u8(torch, gen, (t_rand, ts_rand, ts_rand, 3), dev)
    ts_r = TileSet(palettes=None, paths=[f"r/{i}.jpg" for i in range(t_rand)])
    src_r = np.zeros((side, side, 3), np.uint8)  # random mode reads only its shape
    torch.cuda.synchronize()
    log(f"H set-up: {t_tiles} tiles at ts 16, a {side4}^2 photo, the flagship scene, {t_rand} "
        f"random-mode tiles in {time.perf_counter() - t0:.3f} s")

    times, out = {}, {}
    for kern in KERNELS:
        kern.launches = 0
    with _no_fallback(), _uncertified() as unc:
        for name, kw in (("hybrid", {"hybrid": True}), ("l2", {"metric": "l2"})):
            t0 = time.perf_counter()
            out[name] = render_nto1(src4, ts4, 16, device=dev, compose=False, **kw)
            times[f"mode 4 {side4}^2 render_nto1 {kw} ({(side4 // 4) ** 2} blocks x "
                  f"{2 * t_tiles} rows)"] = (
                time.perf_counter() - t0)
        lines = []
        t0 = time.perf_counter()
        out["nr"] = render_nto1_no_repeat(src, ts, FLAGSHIP_DIM, device=dev, stack=stack,
                                          scorer="hybrid", log=lines.append)
        torch.cuda.synchronize()
        times["flagship render_nto1_no_repeat(scorer='hybrid')"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["random"] = render_random(src_r, ts_r, ts_rand, device=dev, seed=SEED,
                                      stack=stack_r)
        times[f"render_random {side * ts_rand}^2"] = time.perf_counter() - t0
        items_r = random_items(src_r.shape[:2], t_rand, SEED)
        t0 = time.perf_counter()
        bands = list(composite.stream_tinted_bands(items_r, ts_r, stack_r, ts_rand,
                                                   device=dev))
        times[f"random mode {side * ts_rand}^2 streamed composite"] = (
            time.perf_counter() - t0)
    launches = {k.name: k.launches for k in KERNELS}
    for name, secs in times.items():
        log(f"H {name}: {secs:.3f} s [{card}]")
    for ln in lines:
        log(f"H {ln.strip()}")
    log(f"H launches in this slice's paths: {launches}")
    log(f"H hybrid prefilter: {unc['failed']} of {unc['rows']} rows failed the certificate "
        f"(run again with whole segments on K11)")
    # the plans' caps leave the certificate a rare tail: a plan that lost
    # its margin would send many rows through a second pass
    check(unc["failed"] <= unc["rows"] // 100,
          f"{unc['failed']} of {unc['rows']} rows of phase H's prefilter failed the certificate")

    # mode 4 hybrid: exact L1 distances for its rows, and how often its row
    # is the exact argmin's (the candidate set is L2-preselected)
    blocks4 = source_blocks(src4, 4, device=dev)
    lib4 = distance.build_library(torch.as_tensor(pal4, device=dev))
    sample = torch.arange(0, blocks4.shape[0], blocks4.shape[0] // 4096, device=dev)
    xs = blocks4[sample]
    idx = sample.cpu().numpy()
    res = out["hybrid"]
    rows = distance.items_to_rows(torch.as_tensor(res.items.reshape(-1)[idx]), t_tiles)
    hd = res.stats._get_arrays()[3][idx]
    exact_h = (xs.int() - lib4[rows.to(dev).long()].int()).abs().sum(1).cpu().numpy()
    check(np.array_equal(hd, exact_h), "hybrid distances are not the exact L1 of its rows")
    wd, wr = distance.l1_argmin(xs, lib4)
    agree = float((hd == wd.cpu().numpy()).mean())
    check(agree > 0.9, f"hybrid top-1 agrees with the exact argmin on {agree:.3f}")
    # mode 4 L2: the winner's squared distance is the least, from an f64 product
    res = out["l2"]
    rows = distance.items_to_rows(torch.as_tensor(res.items.reshape(-1)[idx]), t_tiles)
    ld = res.stats._get_arrays()[3][idx][::4]
    x64, t64 = xs[::4].double(), lib4.double()
    full = (x64 * x64).sum(1)[:, None] + (t64 * t64).sum(1)[None, :] - 2 * x64 @ t64.T
    got = full.gather(1, rows[::4].to(dev).long()[:, None])[:, 0]
    check(np.array_equal(ld, got.cpu().numpy().astype(np.int64)), "L2 distance of the row")
    check(bool((got == full.min(1).values).all()), "L2 row is not a least squared distance")
    log(f"H mode 4 hybrid: distances exact L1 of its rows on {idx.size} blocks, top-1 = "
        f"the exact argmin's distance on {100 * agree:.2f}% of them; L2: the least squared "
        f"distance on {ld.size} sampled blocks (an f64 product)")
    del blocks4, lib4, xs, x64, t64, full, stack16

    # flagship hybrid no-repeat: the assignment, the image, and the recall of
    # its candidate lists against the exact lists
    nr = out["nr"]
    check(nr.info["scorer"] == "hybrid", f"no-repeat scorer {nr.info['scorer']}")
    items = nr.items.reshape(-1)
    check(bool((items != 0).all()), "a block was left unassigned")
    check(np.unique(np.abs(items)).size == items.size, "a tile was used twice")
    stack_h = stack.cpu().numpy()
    for y in (0, 31, side_n // 2, side_n - 1):
        check(np.array_equal(nr.image[y].reshape(-1),
                             expected_row(nr.items, stack_h, y, FLAGSHIP_DIM)),
              f"H no-repeat image row {y}")
    blocks = source_blocks(src, FLAGSHIP_DIM, device=dev)
    lib = distance.build_library(pal)
    k = min(512, lib.shape[0])
    hd, hr = distance.l1_topk_hybrid(blocks, lib, k, k_pre=min(2 * k, lib.shape[0]))
    ed, er = distance.l1_topk_adaptive(blocks, lib, k)
    s = slice(0, None, 64)
    exact_h = (blocks[::64, None, :].int() - lib[torch.as_tensor(hr[s], device=dev).long()]
               .int()).abs().sum(-1).cpu().numpy()
    check(np.array_equal(hd[s], exact_h), "flagship hybrid list distances are not exact")
    recall = float(np.mean([np.isin(er[i], hr[i]).mean() for i in range(0, len(er), 16)]))
    top1 = float((hd[:, 0] == ed[:, 0]).mean())
    log(f"H flagship hybrid no-repeat: {items.size} blocks, every |item| distinct, image "
        f"rows equal the host composite; its [{len(hd)}, {k}] lists: exact distances, "
        f"recall {100 * recall:.2f}% of the exact lists, top-1 distance exact on "
        f"{100 * top1:.2f}% [{card}]")
    del blocks, lib, pal, stack

    # random mode: the seeded items, in memory and streamed, equal
    img = out["random"]
    check(img.shape == (side * ts_rand, side * ts_rand, 3), f"random image {img.shape}")
    stack_rh = stack_r.cpu().numpy()
    for y in (0, 31, side * ts_rand // 2, side * ts_rand - 1):
        check(np.array_equal(img[y].reshape(-1), expected_row(items_r, stack_rh, y, ts_rand)),
              f"random image row {y}")
    check(np.array_equal(np.concatenate(bands), img), "streamed random bands != in memory")
    log(f"H random mode: {side * ts_rand}^2 image rows equal the host composite of the "
        f"seeded items; the {len(bands)} streamed bands equal it")
    del stack_r, bands, img
    torch.cuda.empty_cache()
    return {"launches": launches, "times": times, "hybrid_top1": agree,
            "nr_recall": recall, "nr_top1": top1}


# ---------------------------------------------------------------------------
# P
# ---------------------------------------------------------------------------


def wall(torch, fn, reps: int = 2):
    """fn()'s result from a first run, and the host seconds of `reps` more
    runs (each ends in a synchronize): the time a caller of a route that
    returns host arrays waits."""
    out = fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def phase_p(torch, gen, dev, card, scene, t_flag=32767, side_flag=4096) -> dict:
    """`parallel/` at full width on virtual meshes of the one card (eight
    positions on cuda:0): each sharded route against the single-device
    route on the same inputs, byte for byte, with both times. A virtual
    mesh measures the shard plumbing's overhead, not a multi-GPU speedup."""
    from emosaic_tpu_torch.ops import distance, lut
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.ops.analysis import source_blocks
    from emosaic_tpu_torch.parallel import (
        make_mesh,
        sharded_build_l1_lut,
        sharded_l1_argmin,
        sharded_l1_argmin_ring,
        sharded_l1_topk,
        sharded_l1_topk_adaptive,
        sharded_mosaic_step,
    )
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat
    from emosaic_tpu_torch.tiles.tileset import TileSet

    t_all = time.perf_counter()
    host = lambda pair: tuple(x.cpu().numpy() for x in pair)  # noqa: E731
    mesh42 = make_mesh(8, model=2, devices=[dev] * 8)
    mesh18 = make_mesh(8, model=8, devices=[dev] * 8)
    mesh8 = make_mesh(8, devices=[dev] * 8)
    log(f"P meshes: {mesh42.shape}, {mesh18.shape}, {mesh8.shape}, every position on {dev}")
    t_tiles = scene["pal4"].shape[0]
    paths = [f"synthetic/{i:06d}.jpg" for i in range(t_tiles)]
    ts4 = TileSet.from_arrays(scene["pal4"], paths)
    stack16 = torch.as_tensor(scene["stack16"], device=dev)
    blocks4 = source_blocks(scene["src4"], 4, device=dev)
    lib4 = distance.build_library(torch.as_tensor(scene["pal4"], device=dev))
    # P1/P2 inputs: ties across library shards (4x2: rows >= 100000 are
    # shard 1; the ring's shards are 25000 rows) and across block shards
    lib_t, blocks_t = lib4.clone(), blocks4.clone()
    lib_t[3 * lib_t.shape[0] // 4] = lib_t[7]
    lib_t[-1] = lib_t[7]
    blocks_t[3] = lib_t[7]
    blocks_t[3 * blocks_t.shape[0] // 4] = lib_t[7]
    lib1 = distance.build_library(torch.as_tensor(scene["pal1"], device=dev))
    b4k, l4k = blocks4[:16384], lib4[:65534]
    pal_f, src_f, ts_f, stack_f = flagship_scene(torch, gen, dev, t_flag, side_flag)
    blocks_f = source_blocks(src_f, FLAGSHIP_DIM, device=dev)
    lib_f = distance.build_library(pal_f)
    torch.cuda.synchronize()
    log(f"P set-up: phase D's scene ({t_tiles} tiles), the flagship scene in "
        f"{time.perf_counter() - t_all:.3f} s")

    # the single-device routes first, so the launch counts below are the
    # sharded routes' alone
    ref, single = {}, {}
    ref["P1"], single["P1"] = wall(torch, lambda: host(distance.l1_argmin(blocks_t, lib_t)))
    ref["P3"], single["P3"] = wall(
        torch, lambda: distance.l1_topk_adaptive(blocks_f, lib_f, 512))
    ref["P4"], single["P4"] = wall(torch, lambda: distance.l1_topk_stripes(b4k, l4k, 512))
    ref["P5"], single["P5"] = wall(torch, lambda: lut._build(lib1.cpu().numpy(), dev).cpu().numpy())
    ref["P6"], single["P6"] = wall(torch, lambda: render_nto1(
        scene["src4"], ts4, 16, device=dev, stack=stack16, log=_quiet).image, reps=1)
    _, single["P7 mode 4"] = wall(torch, lambda: render_nto1(
        scene["src4"], ts4, 16, device=dev, compose=False, log=_quiet), reps=1)
    ref["P7 flagship"], single["P7 flagship"] = wall(torch, lambda: render_nto1_no_repeat(
        src_f, ts_f, FLAGSHIP_DIM, device=dev, compose=False, log=_quiet).items, reps=1)

    for k in KERNELS:
        k.launches = 0
    got, sharded, st3 = {}, {}, {}
    with _no_fallback():
        got["P1"], sharded["P1"] = wall(torch, lambda: sharded_l1_argmin(blocks_t, lib_t, mesh42))
        got["P2"], sharded["P2"] = wall(
            torch, lambda: sharded_l1_argmin_ring(blocks_t, lib_t, mesh8))
        got["P3"], sharded["P3"] = wall(torch, lambda: sharded_l1_topk_adaptive(
            blocks_f, lib_f, 512, mesh18, stats=st3))
        got["P4"], sharded["P4"] = wall(torch, lambda: sharded_l1_topk(b4k, l4k, 512, mesh42))
        got["P5"], sharded["P5"] = wall(torch, lambda: sharded_build_l1_lut(lib1, mesh8))
        got["P6"], sharded["P6"] = wall(torch, lambda: sharded_mosaic_step(
            stack16, scene["src4"], mesh42, 4, 16), reps=1)
        got["P7 mode 4"], sharded["P7 mode 4"] = wall(torch, lambda: render_nto1(
            scene["src4"], ts4, 16, device=dev, compose=False, mesh=mesh42, log=_quiet).items,
            reps=1)
        res7f, sharded["P7 flagship"] = wall(torch, lambda: render_nto1_no_repeat(
            src_f, ts_f, FLAGSHIP_DIM, device=dev, compose=False, mesh=mesh18, log=_quiet),
            reps=1)
    launches = {k.name: k.launches for k in KERNELS}
    got["P7 flagship"] = res7f.items

    ref["P2"] = ref["P1"]
    ref["P7 mode 4"] = scene["items4"]
    bd = lambda b, l: f"B={b.shape[0]} L={l.shape[0]} D={b.shape[1]}"  # noqa: E731
    side4 = scene["src4"].shape[0]
    shapes = {
        "P1": f"sharded_l1_argmin 4x2, {bd(blocks_t, lib_t)}, planted ties",
        "P2": "sharded_l1_argmin_ring n=8, the same inputs",
        "P3": f"sharded_l1_topk_adaptive 1x8, {bd(blocks_f, lib_f)} k=512, clustered",
        "P4": f"sharded_l1_topk 4x2, {bd(b4k, l4k)} k=512",
        "P5": f"sharded_build_l1_lut n=8, L={lib1.shape[0]} (phase D's mode-1 library)",
        "P6": f"sharded_mosaic_step 4x2, {t_tiles} tiles ts 16, {side4}^2 source, mode 4",
        "P7 mode 4": f"render_nto1(mesh=4x2), mode 4 {side4}^2 (items)",
        "P7 flagship": f"render_nto1_no_repeat(mesh=1x8), {side_flag}^2 mode 32 (items)",
    }
    single["P2"] = single["P1"]
    for key, what in shapes.items():
        a, b = got[key], ref[key]
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        for x, y in zip(a, b):
            check(x.shape == y.shape and np.array_equal(x, y),
                  f"{key} {what}: the sharded route differs from the single-device route")
        log(f"P {key} {what}: equal to the single-device route; sharded "
            f"{min(sharded[key]):.4f} s (runs {', '.join(f'{t:.4f}' for t in sharded[key])}), "
            f"single-device {min(single[key]):.4f} s [{card}]")
    check(st3["route"] == "adaptive", f"P3 route {st3['route']}")
    check(st3["certified"] == blocks_f.shape[0], f"P3 certified {st3['certified']}")
    log(f"P3 route {st3['route']} over {st3['shards']} shards, certified "
        f"{st3['certified']}/{blocks_f.shape[0]} rows, fallback {st3['fallback']}")
    info7 = res7f.info
    check(info7["scorer"] == "sharded-exact" and info7["scoring"]["route"] == "adaptive",
          f"P7 flagship scorer {info7['scorer']} {info7['scoring']}")
    log(f"P launches of the sharded routes: {launches}")
    del stack16, blocks4, lib4, lib_t, blocks_t, lib1, pal_f, stack_f, blocks_f, lib_f
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = phase_p8(card)
    t8 = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = phase_p9(card)
    t9 = time.perf_counter() - t0
    log(f"P clock: P1-P7 {t0 - t_all - t8:.1f} s, P8 {t8:.1f} s, P9 {t9:.1f} s, "
        f"total {time.perf_counter() - t_all:.1f} s [{card}]")
    return {"launches": launches, "sharded_s": sharded, "single_s": single, "cli": cli,
            "nccl": nccl}


def phase_p8(card) -> dict:
    """The CLI across two processes on cuda:0 (EMOSAIC_DISTRIBUTED, a
    coordinator on localhost, `--mesh 2`) on phase E's scene and caches:
    rank 0's PNG equals a single-process `--mesh off` run's, rank 1 stands
    down, and the log names the host-staged gloo route."""
    import socket

    from PIL import Image

    env = e_scene()
    out = {}
    for mode, size, down, extra in ((4, 32, 8, []), (16, 32, 8, ["--no-repeat"])):
        base = ["-s", str(size), str(WORK / "photo.jpg"), "mosaic", str(WORK / "tiles"),
                "-m", str(mode), "--downsample", str(down), *extra]
        solo = WORK / f"p8_solo_{mode}.png"
        t_solo, _ = run_cli(["-o", str(solo), *base, "--mesh", "off"], env, f"P8 -m {mode} solo")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist = WORK / f"p8_dist_{mode}.png"
        cmd = [sys.executable, "-m", "emosaic_tpu_torch.cli", "-o", str(dist), *base,
               "--mesh", "2", "--device", "cuda"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, cwd=WORK, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=dict(env, EMOSAIC_DISTRIBUTED="1",
                                           EMOSAIC_COORDINATOR=f"localhost:{port}",
                                           EMOSAIC_NUM_PROCESSES="2",
                                           EMOSAIC_PROCESS_ID=str(r)))
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        t_dist = time.perf_counter() - t0
        for r, (p, err) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                log(err[-4000:])
            check(p.returncode == 0, f"P8 -m {mode} rank {r} exited {p.returncode}")
        check("CUDA partials go over gloo-host-staged" in logs[0],
              "P8: the log does not name the host-staged gloo route")
        check("rank 0 writes the outputs" in logs[1] and "rank 0 writes" not in logs[0],
              "P8: rank 1 did not stand down")
        check("Matching on a 2x1 (data x model) device mesh" in logs[0], "P8: no 2x1 mesh")
        with Image.open(solo) as a, Image.open(dist) as b:
            pa, pb = np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB"))
        check(pa.shape == pb.shape and np.array_equal(pa, pb),
              f"P8 -m {mode} {extra}: rank 0's PNG differs from the single-process PNG")
        route = next(ln for ln in logs[0].splitlines() if "CUDA partials go over" in ln)
        log(f"P8 CLI -m {mode} -s {size} --downsample {down} {' '.join(extra)}: two ranks "
            f"on cuda:0 with --mesh 2 in {t_dist:.1f} s, single process --mesh off in "
            f"{t_solo:.1f} s; rank 0's {pb.shape[1]}x{pb.shape[0]} PNG equals it, rank 1 "
            f"stood down; {route.strip()} [{card}]")
        out[f"m{mode}"] = {"dist_s": t_dist, "solo_s": t_solo}
        for f in (solo, dist, solo.with_suffix(".stats.png"), dist.with_suffix(".stats.png")):
            f.unlink(missing_ok=True)
    return out


_P9_CHILD = """
import json, socket, sys
import torch
sys.path.insert(0, {root!r})
import torch.distributed as dist
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.parallel import make_mesh, sharded_l1_argmin
from emosaic_tpu_torch.parallel.distributed import init_distributed, world
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
init_distributed(f"localhost:{{port}}", 1, 0)
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
blocks = torch.randint(0, 256, (65536, 48), dtype=torch.uint8, device=dev, generator=gen)
lib = torch.randint(0, 256, (200000, 48), dtype=torch.uint8, device=dev, generator=gen)
got = sharded_l1_argmin(blocks, lib, make_mesh(devices=[dev]))
want = [x.cpu().numpy() for x in distance.l1_argmin(blocks, lib)]
equal = bool((got[0] == want[0]).all() and (got[1] == want[1]).all())
print(json.dumps({{"route": world().route, "exchanges": dict(world().exchanges),
                  "equal": equal}}), flush=True)
dist.destroy_process_group()
"""


def phase_p9(card) -> dict:
    """One NCCL world of size 1 in a child process (a process group cannot
    be destroyed and re-made with another backend reliably in one
    process): the route is NCCL, and `sharded_l1_argmin` on a [cuda:0]
    mesh sends its exchange through it."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _P9_CHILD.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
    check(proc.returncode == 0, f"P9 exited {proc.returncode}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(res["route"] == "nccl" and res["exchanges"].get("nccl", 0) >= 1,
          f"P9: route {res['route']}, exchanges {res['exchanges']}")
    check(res["equal"], "P9: sharded_l1_argmin over NCCL differs from l1_argmin")
    log(f"P9 NCCL world of 1: route {res['route']}, exchanges {res['exchanges']}, "
        f"sharded_l1_argmin equal to l1_argmin, {time.perf_counter() - t0:.1f} s [{card}]")
    return res


# ---------------------------------------------------------------------------
# E
# ---------------------------------------------------------------------------


def e_scene() -> dict:
    """Phase E's scene in WORK, made once: 4096 tile files and a 4000x3000
    photo. Returns the environment of the CLI runs (its cache directory is
    WORK/xdg, which later runs reuse)."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # the outputs are 192 MP
    env = dict(os.environ, XDG_CACHE_HOME=str(WORK / "xdg"),
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    if (WORK / "photo.jpg").exists():
        return env
    rng = np.random.default_rng(SEED)
    tiles = WORK / "tiles"
    tiles.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(4096):
        base = rng.integers(0, 256, size=3)
        img = np.clip(base + rng.normal(0, 30, (40, 40, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(tiles / f"t{i:04d}.jpg", quality=90)
    h, w = 3000, 4000
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    photo = np.stack([
        127.5 + 127.5 * np.sin(6.2832 * (1.3 * x / w + 0.7 * y / h)),
        255.0 * y / h,
        255.0 * (x / w) * (1 - y / h) + 60.0 * np.cos(9.0 * x * y / (w * h)),
    ], -1)
    photo = np.clip(photo + rng.normal(0, 6, photo.shape), 0, 255).astype(np.uint8)
    Image.fromarray(photo).save(WORK / "photo.jpg", quality=92)
    log(f"E scene: 4096 tiles + a {w}x{h} photo in {time.perf_counter() - t0:.1f} s")
    return env


def phase_e(card) -> None:
    from PIL import Image

    env = e_scene()
    tiles = WORK / "tiles"
    from emosaic_tpu_torch.cli import preprocess_source

    # the no-repeat runs: 62x47 = 2914 blocks against 4096 tiles
    runs = [(1, 16, 4, [], 0.9), (4, 32, 2, [], 0.9),
            (16, 32, 4, ["--no-repeat"], 0.8),
            (16, 32, 4, ["--no-repeat", "--greedy"], 0.8),
            (16, 32, 4, ["--randomize", "10"], 0.9),
            (4, 32, 4, ["--matcher", "hybrid"], 0.9),
            (4, 32, 4, ["--metric", "l2"], 0.9)]
    for mode, size, down, extra, corr_min in runs:
        out = WORK / f"m{mode}.png"
        secs, stderr = run_cli(["-s", str(size), "-o", str(out), str(WORK / "photo.jpg"),
                                "mosaic", str(tiles), "-m", str(mode), "--downsample",
                                str(down), *extra], env, f"-m {mode} {extra}")
        src = preprocess_source(Image.open(WORK / "photo.jpg"), down, mode)
        with Image.open(out) as im:
            a = np.asarray(im.convert("RGB"))
        corr = block_corr(a, src, mode, size)
        check(corr > corr_min, f"CLI -m {mode} {extra}: block-mean correlation {corr:.3f}")
        check(out.with_suffix(".stats.png").exists(), "stats PNG missing")
        out.with_suffix(".stats.png").unlink()
        timings = [ln.strip() for ln in stderr.splitlines()
                   if ln.startswith("   ") and ln.strip().endswith("s")][:8]
        log(f"E CLI -m {mode} -s {size} --downsample {down} {' '.join(extra)}: {secs:.1f} s, "
            f"{a.shape[1]}x{a.shape[0]}, block-mean corr {corr:.4f}; "
            f"{'; '.join(timings)} [{card}]")
        out.unlink()
    phase_e_html(card, env)
    phase_e_profile(card, env)
    phase_e_random(card, env)


def block_corr(a: np.ndarray, src: np.ndarray, mode: int, size: int) -> float:
    """Correlation of the mosaic's block means with the source's (the
    verify recipe's quality gate); checks the mosaic's shape first."""
    nby, nbx = src.shape[0] // mode, src.shape[1] // mode
    check(a.shape == (nby * size, nbx * size, 3), f"mosaic shape {a.shape}")
    bm = a.reshape(nby, size, nbx, size, 3).mean((1, 3))
    sm = src.reshape(nby, mode, nbx, mode, 3).mean((1, 3))
    return float(np.corrcoef(bm.ravel(), sm.ravel())[0, 1])


def run_cli(args, env, what: str) -> tuple[float, str]:
    """`python -m emosaic_tpu_torch.cli ARGS --device cuda` in WORK; returns
    its seconds and its stderr, raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "emosaic_tpu_torch.cli", *args, "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=WORK, env=env)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"CLI {what} exited {proc.returncode}")
    return time.perf_counter() - t0, proc.stderr


def phase_e_html(card, env) -> None:
    """`--html --web` at mode 1 (a 100x75-block source, -s 16): the main
    page, the widget and both assets, which equal the package's bytes."""
    out = WORK / "web.png"
    secs, _ = run_cli(["-s", "16", "-o", str(out), str(WORK / "photo.jpg"), "mosaic",
                       str(WORK / "tiles"), "-m", "1", "--downsample", "40", "--html",
                       "--web"], env, "--html --web")
    page, widget = WORK / "web.html", WORK / "web_widget.html"
    check(page.exists() and widget.exists(), "--html --web: a page is missing")
    html = widget.read_text()
    check(html.count('class="tile-region"') == 100 * 75, "--web: tile regions")
    check('data-src="tiles/' in html and "file://" not in html, "--web: tile URLs")
    assets = ROOT / "emosaic_tpu_torch" / "web" / "assets"
    for name in ("mosaic-widget.css", "mosaic-widget.js"):
        check((WORK / name).read_bytes() == (assets / name).read_bytes(),
              f"--html --web: {name} differs from the package's")
    log(f"E CLI -m 1 -s 16 --downsample 40 --html --web: {secs:.1f} s; {page.name} "
        f"{page.stat().st_size / 1e3:.1f} kB, {widget.name} {widget.stat().st_size / 1e6:.2f} "
        "MB with 7500 tile regions, both assets equal the package's bytes "
        f"[{card}]")
    for f in (out, out.with_suffix(".stats.png"), page, widget, WORK / "mosaic-widget.css",
              WORK / "mosaic-widget.js"):
        f.unlink()


def phase_e_profile(card, env) -> None:
    """`--profile DIR` at mode 4 (-s 8, downsample 4): the Chrome trace
    parses and names K1's and K2's kernels, and the PNG equals the same run
    without `--profile`."""
    plain, profiled, prof = WORK / "plain.png", WORK / "profiled.png", WORK / "prof"

    def args(out):
        return ["-s", "8", "-o", str(out), str(WORK / "photo.jpg"), "mosaic",
                str(WORK / "tiles"), "-m", "4", "--downsample", "4"]

    secs_plain, _ = run_cli(args(plain), env, "-m 4")
    secs, _ = run_cli(["--profile", str(prof), *args(profiled)], env, "--profile")
    check(profiled.read_bytes() == plain.read_bytes(), "--profile changed the PNG")
    traces = list(prof.glob("*.json"))
    check(len(traces) == 1, f"--profile wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for part in ("l1_argmin", "compose_kernel"):
        check(any(part in k for k in kernels), f"--profile: no {part} kernel in the trace")
    log(f"E CLI -m 4 -s 8 --downsample 4 --profile: {secs:.1f} s (without: {secs_plain:.1f} s); "
        f"trace {traces[0].stat().st_size / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} kernel launches, K1 and K2 among them; PNG equal [{card}]")
    shutil.rmtree(prof)
    for f in (plain, profiled, plain.with_suffix(".stats.png"),
              profiled.with_suffix(".stats.png")):
        f.unlink()


def phase_e_random(card, env) -> None:
    """`-m random` on a 256x192 photo (one tile per pixel, -s 16): the
    output's blocks are the prepared tiles the seeded item grid names."""
    from PIL import Image

    from emosaic_tpu_torch.io.discovery import find_images
    from emosaic_tpu_torch.io.prep import prepare_tile
    from emosaic_tpu_torch.render.random_mode import random_items

    with Image.open(WORK / "photo.jpg") as im:
        im.resize((256, 192)).save(WORK / "small.png")
    out, tiles = WORK / "random.png", WORK / "tiles"
    secs, _ = run_cli(["-s", "16", "-o", str(out), str(WORK / "small.png"), "mosaic",
                       str(tiles), "-m", "random", "--seed", "7"], env, "-m random")
    with Image.open(out) as im:
        a = np.asarray(im.convert("RGB"))
    check(a.shape == (192 * 16, 256 * 16, 3), f"random output {a.shape}")
    paths = find_images(tiles, {"jpg", "jpeg"})
    items = random_items((192, 256), len(paths), 7)
    rng = np.random.default_rng(SEED)
    for y, x in zip(rng.integers(0, 192, 24), rng.integers(0, 256, 24)):
        want = prepare_tile(paths[items[y, x] - 1], 16, crop=True)
        check(np.array_equal(a[y * 16 : y * 16 + 16, x * 16 : x * 16 + 16], want),
              f"random block ({y}, {x})")
    check(not out.with_suffix(".stats.png").exists(), "random mode wrote stats")
    log(f"E CLI -m random -s 16 on a 256x192 photo: {secs:.1f} s, {a.shape[1]}x{a.shape[0]}, "
        f"24 sampled blocks equal the prepared tiles of the seeded items [{card}]")
    out.unlink()


# ---------------------------------------------------------------------------
# S
# ---------------------------------------------------------------------------


def _quiet(*a):
    pass


def http(base: str, query: str = "", data: bytes | None = None, path: str = "/mosaic",
         timeout: float = 600) -> tuple[int, dict, bytes]:
    """(status, headers, body) of one GET (no data) or POST; the body of a
    chunked response comes de-chunked. An HTTP error status raises."""
    import urllib.request

    req = urllib.request.Request(f"{base}{path}{query}", data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def serving(handler):
    """Context: a ThreadingHTTPServer on 127.0.0.1, an ephemeral port, with
    `handler`; yields (base URL, port) and stops the server after."""
    import contextlib
    import threading
    from http.server import ThreadingHTTPServer

    @contextlib.contextmanager
    def ctx():
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd.server_address[1]
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)

    return ctx()


def timed_class(base: str, body: bytes, query: str, what: str, card: str,
                n_warm: int = 5) -> tuple[bytes, dict]:
    """One request class: a first request, then `n_warm` more; prints the
    first time and the warm median; returns the first response's body and
    headers."""
    times, first = [], None
    for _ in range(1 + n_warm):
        t0 = time.perf_counter()
        status, headers, data = http(base, query, body)
        times.append(time.perf_counter() - t0)
        check(status == 200 and headers["Content-Type"] == "image/png", f"S {what}: {status}")
        first = first or (data, headers)
    warm = sorted(times[1:])
    log(f"S {what}: first request {times[0]:.3f} s, warm median {warm[len(warm) // 2]:.3f} s "
        f"(min {warm[0]:.3f}, max {warm[-1]:.3f}) of {n_warm}; {len(first[0]) / 1e6:.1f} MB "
        f"[{card}]")
    return first


def replay_split(torch, svc, body: bytes, card: str, what: str, *, downsample: int,
                 tint: float = 0.0, no_repeat: bool = False, greedy: bool = False,
                 stream: bool = False):
    """A warm request's work replayed step by step on the service's state,
    each step ending in a synchronize: decode + preprocess, the match or
    the scoring and assignment, the stack upload, the composite, the tint
    and the PNG encode. Prints the split; returns (PNG bytes, the image or
    None when streamed)."""
    import io

    from PIL import Image

    from emosaic_tpu_torch.cli import preprocess_source
    from emosaic_tpu_torch.io.codecs import StreamingPNGWriter
    from emosaic_tpu_torch.ops import composite
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat

    dev, ts = svc.device, svc.tile_size
    split = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        return out

    def decode():
        original = Image.open(io.BytesIO(body))
        src = preprocess_source(original, downsample, svc.dim)
        rgb = np.asarray(original.convert("RGB"), dtype=np.uint8) if tint else None
        return src, rgb

    src, rgb = step("decode + preprocess", decode)
    if no_repeat and not greedy:
        out = step("score + assign + stats", lambda: render_nto1_no_repeat(
            src, svc.tile_set, ts, device=dev, stack=svc.stack, compose=False, log=_quiet))
        split["  of it scoring"] = out.info["scoring_s"]
        split["  of it assignment"] = out.info["assign_s"]
    else:
        name = "top-k + greedy + stats" if no_repeat else "match + stats"
        out = step(name, lambda: render_nto1(
            src, svc.tile_set, ts, no_repeat=no_repeat, device=dev, stack=svc.stack,
            compose=False, log=_quiet))
    nby, nbx = out.items.shape
    if stream:
        def encode_stream():
            buf = io.BytesIO()
            with StreamingPNGWriter(buf, nbx * ts, nby * ts) as w:
                for band in composite.stream_tinted_bands(
                        out.items, out.tile_set, svc.stack, ts, original_rgb=rgb,
                        tint_opacity=tint, device=dev):
                    w.write_band(band)
            return buf.getvalue()

        png, image = step("stack upload + compose + tint + streamed PNG encode",
                          encode_stream), None
    else:
        aug = step("stack upload + augment", lambda: composite.augment_stack2d(
            svc.stack, device=dev)[0])
        image = step("compose (K2) + copy to host", lambda: composite.compose_rows(
            torch.as_tensor(out.items, device=dev), aug).cpu().numpy().reshape(
                nby * ts, nbx * ts, 3))
        del aug
        if tint:
            image = step("tint", lambda: composite.tint_blend(image, rgb, tint, device=dev))

        def encode():
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, "PNG")
            return buf.getvalue()

        png = step("PNG encode", encode)
    total = sum(v for k, v in split.items() if not k.startswith(" "))
    log(f"S {what}, split of a warm request (replayed): "
        + "; ".join(f"{k.strip()} {v:.3f} s" for k, v in split.items())
        + f"; sum {total:.3f} s [{card}]")
    return png, image


def start_serve(env, args) -> tuple[subprocess.Popen, int]:
    """`python -m emosaic_tpu_torch.serve ARGS` in WORK; returns the process
    and its port once it prints its "serving on" line. Its stderr is then
    drained by a thread so its logging cannot block it."""
    import re
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "emosaic_tpu_torch.serve", *args],
                            cwd=WORK, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
        if m:
            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return proc, int(m.group(1))
    proc.wait(timeout=60)
    log("".join(lines)[-4000:])
    raise AssertionError(f"the serve process exited {proc.returncode} before serving")


def stop_serve(proc) -> None:
    import signal

    proc.send_signal(signal.SIGINT)  # KeyboardInterrupt: serve_forever returns
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        raise AssertionError("the serve process did not stop on SIGINT")
    check(proc.returncode == 0, f"the serve process exited {proc.returncode}")


def stalled_stream(torch, svc, body: bytes, card: str) -> None:
    """A client that stops reading a streamed response: the spool fills,
    the producer aborts after its 0.5 s stall, the socket write dies at
    the 3 s deadline; the card's memory returns to its level before the
    request and the next request renders."""
    import socket
    import threading

    from emosaic_tpu_torch.serve import _make_handler

    aborted, lost = threading.Event(), threading.Event()

    def watch(msg, *a):
        if "stream aborted" in msg:
            aborted.set()
        if "stream client lost" in msg:
            lost.set()

    handler = _make_handler(svc, stream_threshold=1 << 20, spool_bytes=4096,
                            spool_stall_secs=0.5, io_timeout=3.0)
    svc.log = watch
    with serving(handler) as (base, port):
        http(base, "?downsample=4", body)  # a whole streamed response first
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.settimeout(60)
        s.connect(("127.0.0.1", port))
        t0 = time.perf_counter()
        s.sendall(b"POST /mosaic?downsample=4 HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        # parked, not reading, until the producer has aborted and the
        # blocked socket write has hit its deadline
        check(aborted.wait(120) and lost.wait(120), "stalled stream: no abort")
        data = b""
        while True:
            got = s.recv(1 << 20)
            if not got:
                break
            data += got
        s.close()
        secs = time.perf_counter() - t0
        check(data.startswith(b"HTTP/1.1 200"), "stalled stream: no 200")
        check(not data.endswith(b"0\r\n\r\n"), "stalled stream completed")
        after = torch.cuda.memory_allocated()
        for _ in range(50):  # the handler thread returns just after the close
            if after <= before:
                break
            time.sleep(0.1)
            after = torch.cuda.memory_allocated()
        check(after <= before, f"stalled stream kept {after - before} bytes on the card")
        held = torch.cuda.max_memory_allocated() - before
        check(held > 0, "stalled stream: the request held nothing on the card")
        status, _, png = http(base, "?downsample=4", body)
        check(status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n", "no render after the abort")
    svc.log = _quiet
    log(f"S stalled stream: {len(data) / 1e6:.1f} MB received before the server closed it "
        f"{secs:.1f} s after the request (truncated); device memory {before} bytes before, "
        f"{held / 1e6:.1f} MB more at its peak, {after} after; the next request rendered "
        f"[{card}]")


def phase_s(torch, card) -> dict:
    """The resident service (`emosaic_tpu_torch.serve`) on phase E's 4096
    tile files and 4000x3000 photo, in this process behind its HTTP
    handler, then as `python -m emosaic_tpu_torch.serve`."""
    import io
    import threading

    from PIL import Image

    from emosaic_tpu_torch.cli import preprocess_source
    from emosaic_tpu_torch.ops import composite
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.serve import MosaicService, _make_handler

    os.environ["XDG_CACHE_HOME"] = str(WORK / "xdg")  # phase E's caches
    body = (WORK / "photo.jpg").read_bytes()
    with Image.open(WORK / "photo.jpg") as im:
        src4 = preprocess_source(im, 4, 4)
        src4_16 = preprocess_source(im, 16, 4)
        src16 = preprocess_source(im, 4, 16)
        photo = np.asarray(im.convert("RGB"))
    t0 = time.perf_counter()
    svc = MosaicService(WORK / "tiles", "4", 32, device="cuda", log=_quiet)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.warmup(1000, 750)
    log(f"S service -m 4 -s 32: {len(svc.tile_set)} tiles, ready in {t_init:.2f} s, warmup "
        f"1000x750 (kernel build, native engine, one request) {time.perf_counter() - t0:.2f} s "
        f"[{card}]")
    svc16 = MosaicService(WORK / "tiles", "16", 32, device="cuda", log=_quiet)
    svc16.warmup(1000, 750, no_repeat=True)

    for k in KERNELS:
        k.launches = 0
    with _no_fallback():
        with serving(_make_handler(svc)) as (base, _):
            status, _, health = http(base, path="/healthz")
            check(json.loads(health) == {"status": "ok", "tiles": 4096, "mode": "4",
                                         "tile_size": 32}, f"S /healthz {health}")
            buffered, _ = timed_class(base, body, "?downsample=4", "buffered -m 4 -s 32 "
                                      "--downsample 4 (8000x5984)", card)
            # the tinted class at downsample 16 (2000x1496): a tinted PNG
            # compresses worse, and Pillow's single-threaded encode of one at
            # downsample 4 would take much of the phase's time
            tinted, _ = timed_class(base, body, "?downsample=16&tint=0.3",
                                    "tinted 0.3 at downsample 16 (2000x1496)", card)
            # /healthz while a render is in flight
            entered, release = threading.Event(), threading.Event()
            real = svc.render_plan

            def held(*a, **k):
                entered.set()
                check(release.wait(60), "S: the in-flight render was never released")
                return real(*a, **k)

            svc.render_plan = held
            result = {}
            th = threading.Thread(target=lambda: result.update(
                r=http(base, "?downsample=16&tint=0.3", body)), daemon=True)
            th.start()
            check(entered.wait(60), "S: the render never started")
            t0 = time.perf_counter()
            status, _, health = http(base, path="/healthz", timeout=10)
            t_health = time.perf_counter() - t0
            check(status == 200 and "r" not in result, "S: /healthz not answered in flight")
            release.set()
            th.join(timeout=300)
            del svc.render_plan
            check(not th.is_alive() and result["r"][2] == tinted,
                  "S: the in-flight render's PNG differs")
            log(f"S /healthz answered in {1e3 * t_health:.1f} ms while a render was in "
                f"flight [{card}]")
        with serving(_make_handler(svc, stream_threshold=1 << 20)) as (base, _):
            streamed, headers = timed_class(base, body, "?downsample=4",
                                            "streamed (chunked), same shape", card)
            check(headers.get("Transfer-Encoding") == "chunked", "S: not chunked")
        stalled_stream(torch, svc, body, card)
        with serving(_make_handler(svc16)) as (base, _):
            nr, _ = timed_class(base, body, "?downsample=4&no_repeat=1",
                                "no_repeat -m 16 -s 32 --downsample 4", card)
            nrg, _ = timed_class(base, body, "?downsample=4&no_repeat=1&greedy=1",
                                 "no_repeat + greedy, same shape", card)
    launches = {k.name: k.launches for k in KERNELS}
    log(f"S launches inside the service: {launches}")
    for name in ("l1_argmin", "compose", "l1_stripe"):
        check(launches[name] > 0, f"S: {name} was not launched by the service")
    log("S scorer kernels reached by the no-repeat requests: "
        + (", ".join(f"{n} {launches[n]}" for n in ("l1_stripe", "l1_topcap", "l1_rows",
                                                     "coarse_topcap", "seg_topcap")
                     if launches[n]) or "none"))

    # outputs: the service's PNGs against the same work in this process
    png, image = replay_split(torch, svc, body, card, "buffered", downsample=4)
    ref = render_nto1(src4, svc.tile_set, 32, device=svc.device, stack=svc.stack,
                      log=_quiet).image
    check(np.array_equal(image, ref), "S: the replay's image != render_nto1's")
    check(buffered == png, "S: buffered PNG != render_nto1 + PNG encode")
    corr = block_corr(image, src4, 4, 32)
    check(corr > 0.9, f"S buffered: block-mean correlation {corr:.3f}")
    png_t, image_t = replay_split(torch, svc, body, card, "tinted", downsample=16, tint=0.3)
    check(tinted == png_t, "S: tinted PNG != the replay's")
    ref16 = render_nto1(src4_16, svc.tile_set, 32, device=svc.device, stack=svc.stack,
                        log=_quiet).image
    check(np.array_equal(image_t, composite.tint_blend(ref16, photo, 0.3, device=svc.device)),
          "S: tinted image != tint_blend of render_nto1's")
    png_s, _ = replay_split(torch, svc, body, card, "streamed", downsample=4, stream=True)
    check(streamed == png_s, "S: streamed PNG != the replay's")
    with Image.open(io.BytesIO(streamed)) as im:
        check(np.array_equal(np.asarray(im.convert("RGB")), image),
              "S: chunked body != buffered image")
    png_nr, image_nr = replay_split(torch, svc16, body, card, "no_repeat", downsample=4,
                                    no_repeat=True)
    png_g, image_g = replay_split(torch, svc16, body, card, "no_repeat + greedy",
                                  downsample=4, no_repeat=True, greedy=True)
    check(nr == png_nr and nrg == png_g, "S: a no-repeat PNG != the replay's")
    corrs = [block_corr(img, src16, 16, 32) for img in (image_nr, image_g)]
    check(min(corrs) > 0.8, f"S no-repeat: block-mean correlations {corrs}")
    log(f"S outputs: buffered PNG == render_nto1 + PNG encode (block-mean corr {corr:.4f}); "
        "tinted == tint_blend of it; the chunked body decodes to the buffered image; "
        f"no_repeat and greedy equal their replays (corr {corrs[0]:.4f}, {corrs[1]:.4f}) "
        f"[{card}]")

    # the entry point a user runs
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        str(ROOT), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc, port = start_serve(env, [str(WORK / "tiles"), "-m", "4", "-s", "32", "--device",
                                   "cuda", "--port", "0", "--warmup", "1000x750"])
    t_up = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{port}"
        status, _, health = http(base, path="/healthz")
        check(status == 200 and json.loads(health)["tiles"] == 4096, "S subprocess /healthz")
        t0 = time.perf_counter()
        status, _, got = http(base, "?downsample=16&tint=0.3", body)
        t_req = time.perf_counter() - t0
        check(status == 200 and got == tinted, "S subprocess: PNG != the in-process one")
    finally:
        stop_serve(proc)
    log(f"S python -m emosaic_tpu_torch.serve ... --warmup 1000x750: serving after "
        f"{t_up:.1f} s (start, warmup); first request (tinted, downsample 16) {t_req:.3f} s, "
        f"PNG equal to the in-process service's; stopped by SIGINT [{card}]")
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs a GPU",
              file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops._kernels import KERNELS

    shutil.rmtree(WORK, ignore_errors=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t_all = time.perf_counter()
    try:
        card = phase_a(torch)
        phase_b()
        log("== C. kernels against their plain versions on the card")
        rate = vsad_rate(torch, dev, card)
        k1 = phase_c_k1(torch, gen, dev, card, rate)
        k2 = phase_c_k2(torch, gen, dev, card)
        k3 = phase_c_k3(torch, gen, dev, card, rate)
        k4 = phase_c_k4(torch, gen, dev, card)
        k9 = phase_c_k9(torch, gen, dev, card, fadd_rate(torch, dev, card))
        k10s, k10t = phase_c_k10(torch, gen, dev, card, rate)
        k11a, k11t = phase_c_k11(torch, gen, dev, card)
        k12 = phase_c_k12(torch, dev, card, rate)
        k13 = phase_c_k13(torch, dev, card)
        k5 = phase_c_k5(torch, gen, dev, card)
        k6, k7 = phase_c_k6_k7(torch, gen, dev, card)
        k8 = phase_c_k8(torch, gen, dev, card)
        phase_c_tint_lut(torch, gen, dev, card)
        phase_c_no_fallback(torch, gen, dev)
        log("== D. main path at the BASELINE size")
        d_scene = phase_d(torch, gen, dev, card)
        launches_d = d_scene.pop("launches")
        torch.cuda.empty_cache()
        log("== N. the no-repeat main path at the flagship size")
        n = phase_n(torch, gen, dev, card)
        launches_n = n["launches"]
        log("== L. the lab probes")
        lab = phase_l(torch, dev, card)
        launches_l = lab["launches"]
        log("== H. the hybrid, L2 and random paths at full width")
        h = phase_h(torch, gen, dev, card)
        launches_h = h["launches"]
        log("== E. the CLI")
        phase_e(card)
        log("== S. the resident service")
        launches_s = phase_s(torch, card)
        log("== P. parallel/: the sharded routes, the CLI over two processes, NCCL")
        p = phase_p(torch, gen, dev, card, d_scene)
        launches_p = p["launches"]
        del d_scene
        log("== F. counters")
        launches_w = n["launches_worst"]
        for path, counts, names in [("D", launches_d, ("l1_argmin", "compose")),
                                    ("N", launches_n, ("l1_rows", "coarse_topcap", "compose")),
                                    ("N's full consumption", n["launches_consume"],
                                     ("masked_refill",)),
                                    ("N's refilling render", n["launches_refill"],
                                     ("masked_refill",)),
                                    ("N's worst case", launches_w, ("l1_topcap", "l1_stripe")),
                                    ("H", launches_h, ("l1_rows", "compose", "l2_argmin",
                                                       "l2_topcap")),
                                    ("S", launches_s, ("l1_argmin", "compose", "l1_stripe",
                                                       "row_sort")),
                                    ("P", launches_p, ("l1_argmin", "compose", "l1_rows",
                                                       "coarse_topcap", "l1_topcap")),
                                    ("L", launches_l, ("seg_topcap", "coarse_topcap",
                                                       "floor_write", "compose_bulk",
                                                       "compose_bulk2", "band_transpose"))]:
            for name in names:
                log(f"{name}: {counts[name]} launches in {path}")
                check(counts[name] > 0, f"{name} was not launched by the {path} path")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    rows = []
    for k, res, replaces, launches in [
        (KERNELS[0], k1, "emosaic_tpu/ops/distance.py:190", launches_d),
        (KERNELS[1], k2, "emosaic_tpu/ops/composite.py:119", launches_d),
        (KERNELS[2], k3, "emosaic_tpu/ops/distance.py:1535", launches_n),
        (KERNELS[3], k4, "tools/tpu_r14_seg8.py:62", launches_l),
        (KERNELS[4], k5, "tools/tpu_r3_experiments.py:171", launches_l),
        (KERNELS[5], k6, "tools/tpu_r3_experiments2.py:188", launches_l),
        (KERNELS[6], k7, "tools/tpu_r3_experiments3.py:67", launches_l),
        (KERNELS[7], k8, "tools/tpu_bench_composite_variants.py:43", launches_l),
        (KERNELS[8], k9, "tools/tpu_r14_seg8.py:62", launches_n),
        (KERNELS[9], k10s, "emosaic_tpu/ops/distance.py:1094", launches_w),
        (KERNELS[10], k10t, "emosaic_tpu/ops/distance.py:1121", launches_w),
        (KERNELS[11], k11a, "emosaic_tpu/ops/distance.py:909", launches_h),
        (KERNELS[12], k11t, "emosaic_tpu/ops/distance.py:706", launches_h),
        (KERNELS[13], k12, "none", n["launches_refill"]),
        (KERNELS[14], k13, "none", launches_s),
    ]:
        rows.append({
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)), "replaces": replaces,
            "launches": launches[k.name], "launches_s": launches_s[k.name], **res,
        })
    for i in (0, 1, 2, 8, 9, 10):  # the kernels of phase P's sharded routes
        rows[i]["launches_p"] = launches_p[rows[i]["name"]]
    for i in (9, 10):  # K10's launches in N's render (refills, fallbacks) and in H
        rows[i].update(launches_n_render=launches_n[rows[i]["name"]],
                       launches_h=launches_h[rows[i]["name"]])
    rows[9]["also_replaces"] = ("emosaic_tpu/ops/distance.py:461 (_l1_topk_stripes_jit) and "
                                ":863 (_l1_matrix_jit): XLA-fused stripes, no Pallas kernel")
    rows[10]["also_replaces"] = ("the XLA-fused stripe + lax.top_k of _l1_topk_twolevel_jit, no "
                                 "Pallas kernel; its selection is tools/tpu_r14_seg8.py:62's")
    rows[11]["also_replaces"] = ("none: _l2_argmin_jit's XLA dot + argmin "
                                 "(emosaic_tpu/ops/distance.py:908-940), no Pallas kernel")
    rows[12]["also_replaces"] = ("none: _mxu_prefilter_jit's XLA dot + approx_min_k "
                                 "(emosaic_tpu/ops/distance.py:703-723), no Pallas kernel")
    rows[13]["also_replaces"] = ("none: the refill chain of ops/refill.py `_refill_topk` "
                                 "(gather, K10's stripe, packed-key torch.topk); the JAX "
                                 "package's `_refill_topk_jit` is XLA, no Pallas kernel")
    rows[13].update(consume_device_s=n["consume_device_s"], consume_host_s=n["consume_host_s"],
                    consume_events=n["consume_events"], consume_fused=n["consume_fused"],
                    launches_consume=n["launches_consume"]["masked_refill"],
                    refill_render_s=n["refill_render_s"],
                    refill_render_host_s=n["refill_render_host_s"],
                    refill_render_calls=n["refill_calls"], refill_render_fused=n["refill_fused"])
    rows[14]["also_replaces"] = ("none: the exact-full route's host sort (stable np.argsort, "
                                 "take_along_axis, int32 casts; the JAX package's "
                                 "emosaic_tpu/render/norepeat.py:121-123)")
    rows[1]["also_replaces"] = "emosaic_tpu/ops/composite.py:82"
    rows[2]["also_replaces"] = "tools/tpu_r19_flatdma.py:48"
    rows[2]["launches_h"] = launches_h["l1_rows"]
    rows[2].update(ms_flagship_lists=n["k3_lists_ms"], reuse_flagship_lists=n["k3_lists_reuse"],
                   shape_flagship_lists=n["k3_lists_shape"])
    for i in (0, 2, 9, 10):
        rows[i]["vabsdiff4_rate_measured"] = rate["measured"]
    rows[2]["flatdma_steps"] = lab["flatdma"]["steps"]
    seg = lab["seg8"]
    rows[3].update(ms_200k_chunk=seg["k4_ms"], plain_ms_200k_chunk=seg["plain_ms"],
                   library_ms_200k_chunk=seg["library_ms"],
                   shape_200k_chunk=f"[{seg['rows']}, {seg['lp']}] cap {seg['cap']}",
                   launches_n=launches_n["seg_topcap"])
    rows[8].update(coarse_k9_s_200k=seg["coarse_k9_s"],
                   coarse_cdist_k4_s_200k=seg["coarse_cdist_k4_s"],
                   coarse_plain_s_200k=seg["coarse_plain_s"], launches_l=launches_l["coarse_topcap"],
                   also_replaces="emosaic_tpu/ops/distance.py:1422 (_ad_coarse_core_jit, "
                                 "XLA-fused stripe + lax.top_k, no Pallas kernel)")
    r3, cv = lab["r3"]["ms"], lab["variants"]["ms"]
    rows[5]["also_replaces"] = "tools/tpu_r3_experiments3.py:102"
    rows[4].update(ms_probe_c5=r3["C5"], fill_ms_probe_c5=r3["C5_fill"])
    rows[5].update(ms_probe_c6=r3["C6"], ms_probe_c9=r3["C9"], run_c=lab["r3"]["run"])
    rows[6].update(ms_probe_c1=r3["C1"], ms_probe_c8=r3["C8"], ms_probe_c10=r3["C10"],
                   run_c=lab["r3"]["run"])
    rows[7].update(ms_probe_relayout=cv["relayout K8"], ms_probe_v3d=cv["v3d"],
                   ms_probe_v1=cv["v1"], ms_probe_v4=cv["v4"], ms_probe_k2=cv["K2"])
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
