#!/usr/bin/env python3
"""K4 (`csrc/seg_topcap.cu`) alone and the adaptive scorer's coarse pass
(K9, `csrc/coarse_topcap.cu`, and the cdist stripe + K4) on one GPU.

    python3 emosaic_tpu_torch/probes/k4_k9.py [--root DIR] [--ptxas] [--sass] [--rates]
                                              [--quick] [--label NAME]

`--root` imports `emosaic_tpu_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked into a git-ignored directory),
so two versions are timed by the same script on the same card: run it as
parent, change, change, parent in one call. The kernels of that checkout
are built there, from its own sources; a checkout without K9 times its
coarse pass as it is (the cdist stripe + K4). `--ptxas` prints ptxas's
register, shared-memory and spill report of K4 and K9 first, `--sass` the
static instruction mix of every kernel in K9's library (`cuobjdump -sass`:
FADD, LDS, IMNMX, ISETP, BAR and the video instructions), `--rates` the
FP32 lanes alone (`emosaic_fadd_rate`), the packed 16-bit `vabsdiff2.add`
alone (`emosaic_vabsdiff2_rate`) and the selection's integer min/max alone
(`emosaic_vimnmx_rate`), where the checkout has them, at 1, 2, 4 and 8
blocks of 256 threads an SM. `--quick` stops after the exact checks.
(Nsight Compute fails on the card's machine: LibraryNotLoaded.)

It checks K4 against `_seg_topcap_ref` and K9 against `_coarse_topcap_ref`
(keys and s_min bit for bit) at small shapes aimed at a persistent,
pipelined kernel (fewer items than SMs, item counts not a multiple of 132,
ragged rows and real_l, dout 6, 27, 96 and 1536, caps 1, 8, 16, 32 and 33,
tie storms), then times with CUDA events (mean of several launches after a
warm-up):

- K4 on the flagship coarse stripe [16384, 65536] int32 at cap 16 and on
  the 200k-shape chunk [1341, 200064] at cap 8 (`probes/seg8.py`);
- K9 alone: one launch at the flagship shape (16384 projected rows x 512
  segments x dout 96, cap 16), one at the coarse pass's chunk (4096 rows)
  and one at the 200k shape (1341 rows x 1563 segments x dout 96, cap 8),
  each beside its FP32 ceiling (the coordinate pairs over the FP32 lanes,
  two FADDs a pair) and its issue floor (two FADDs a pair and the
  selection's 2 * CAPL + 4 instructions a position, at 4 warp
  instructions an SM a clock), with the SM clock and power sampled while
  the flagship launch runs;
- the coarse pass `_ad_coarse` at the flagship shape (B=16384 blocks
  against L=65534 rows of D=3072, g=32 per channel, cap 16: 4 launches)
  on random palettes, with K9, and with the cdist stripe + K4 (both
  bit-equal);
- the peak device bytes of `_ad_coarse_lib` + `_ad_coarse` at a 2M-row
  library (D=3072, 1024 blocks, cap 8), as `probes/flatdma.py` step D.

The last line of its output is one JSON object of the numbers, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

# (name, rows, nseg, dout, cap) of the K9 launches timed alone
K9_SHAPES = (("k9_flagship", 16384, 512, 96, 16), ("k9_chunk", 4096, 512, 96, 16),
             ("k9_200k", 1341, 1563, 96, 8))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5) -> float:
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


def projected_case(torch, gen, dev, rows, nseg, dout, g, kind, real_l=None):
    """(xp [rows, dout] i32, coarse library (proj, cols, real_l)) in projected
    units (group sums of g cells, 0..255 g), laid out as `_ad_coarse_lib`
    lays it out: "clustered" is 40 centres +-2g, "storm" 3 rows repeated
    over the whole library (ties in every segment and across segments)."""
    lp = nseg * 128
    top = 255 * g
    cen = torch.randint(0, top + 1, (40 if kind == "clustered" else 3, dout), device=dev,
                        generator=gen)
    lib = cen[torch.randint(0, cen.shape[0], (lp,), device=dev, generator=gen)]
    if kind == "clustered":
        lib = lib + torch.randint(-2 * g, 2 * g + 1, (lp, dout), device=dev, generator=gen)
    lib = lib.clamp(0, top).to(torch.int32)
    pick = torch.randint(0, lp, (rows,), device=dev, generator=gen)
    xp = (lib[pick] + torch.randint(-g, g + 1, (rows, dout), device=dev, generator=gen)
          ).clamp(0, top).to(torch.int32)
    pos = torch.arange(lp, device=dev)
    cols = ((pos % 128) * nseg + pos // 128).to(torch.int32)
    # position s*128 + k holds library row k*nseg + s
    proj = lib.view(128, nseg, dout).permute(1, 2, 0).float().contiguous()
    return xp, (proj, cols, lp - 37 if real_l is None else real_l)


# (rows, nseg, dout, g, real_l offset from lp) of the exact checks: fewer
# items than SMs, item counts not a multiple of 132, ragged rows, padding
# that fills whole segments, dout 6 / 27 / 96 / 1536
K9_CHECKS = ((5, 3, 6, 8, 37), (300, 51, 27, 4, 200), (129, 7, 96, 32, 1), (1, 1, 6, 8, 100),
             (257, 2, 1536, 32, 37), (700, 40, 96, 32, 37))


def check_k9(torch, distance, gen, dev, label: str) -> int:
    n = 0
    for rows, nseg, dout, g, pad in K9_CHECKS:
        for kind in ("clustered", "storm"):
            xp, cl = projected_case(torch, gen, dev, rows, nseg, dout, g, kind,
                                    nseg * 128 - pad)
            for cap in (1, 8, 16, 32, 33):
                keys = torch.empty((rows, nseg * cap), dtype=torch.int64, device=dev)
                s_min = torch.empty((rows,), dtype=torch.int32, device=dev)
                distance.coarse_topcap(xp, cl, cap, keys, s_min)
                torch.cuda.synchronize()
                wk, ws = distance._coarse_topcap_ref(xp, cl[0], cl[1], cap, cl[2])
                if not (torch.equal(keys, wk) and torch.equal(s_min, ws)):
                    raise AssertionError(f"[{label}] K9 rows={rows} nseg={nseg} dout={dout} "
                                         f"cap={cap} {kind}: kernel != plain")
                n += 1
    return n


def rates(torch, dev, lib: Path, label: str, card: str) -> dict:
    """Pairs/s of the FP32 probe (one pair = 2 FADDs) and of the packed
    16-bit probe (one `vabsdiff2.add` = 2 pairs), and VIMNMX/s of the
    selection's integer min/max probe (112 an iteration, 3.5 for each of
    the 32 steps the rate's formula counts), at 1, 2, 4 and 8 blocks of
    256 threads an SM."""
    so = ctypes.CDLL(str(lib))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    res = {}
    for sym, pairs_per_step, unit in (("emosaic_fadd_rate", 1, "pairs"),
                                      ("emosaic_vabsdiff2_rate", 2, "pairs"),
                                      ("emosaic_vimnmx_rate", 3.5, "VIMNMX")):
        if not hasattr(so, sym):
            print(f"[{label}] {sym}: not in this checkout", flush=True)
            continue
        fn = getattr(so, sym)
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        res[sym] = {}
        for per in (1, 2, 4, 8):
            iters = 16384 // per

            def run():
                if fn(dev.index, out.data_ptr(), sms * per, iters, stream) != 0:
                    raise RuntimeError(f"{sym} launch failed")

            ms = cuda_ms(torch, run, reps=3)
            rate = sms * per * 256 * 32 * iters * pairs_per_step / (ms * 1e-3)
            res[sym][per] = rate
            print(f"[{label}] {sym} at {per} block(s) of 256 threads an SM: "
                  f"{rate / 1e12:.2f} T {unit}/s [{card}]", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k4_k9: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = card_line()
    label = args.label or str(root)
    fused = hasattr(distance, "coarse_topcap")
    kernels = [_kernels.SEG_TOPCAP] + ([_kernels.COARSE_TOPCAP] if fused else [])
    print(f"[{label}] {card}", flush=True)
    t0 = time.perf_counter()
    secs = _kernels.build_all(tuple(kernels), force=True)
    print(f"[{label}] built {secs} in {time.perf_counter() - t0:.2f} s", flush=True)
    out = {"label": label, "card": card, "k9": fused}
    if args.ptxas:
        from emosaic_tpu_torch.probes.k10 import ptxas_report

        ptxas_report(kernels)
    if args.sass and fused:
        from emosaic_tpu_torch.probes.k10 import sass_mix

        out["sass"] = {}
        for name, counts in sass_mix(_kernels.COARSE_TOPCAP.library, "").items():
            total = sum(counts.values())
            picked = {op: n for op, n in counts.items()
                      if op in ("FADD", "LDS", "IMNMX", "VIMNMX", "ISETP", "BAR", "SYNCS",
                                "VABSDIFF", "VABSDIFF4", "PRMT", "IADD3", "LOP3")}
            top = ", ".join(f"{k} {v}" for k, v in list(counts.items())[:12])
            print(f"[{label}] SASS {name}: {total} instructions; {picked}; top: {top}",
                  flush=True)
            out["sass"][name] = {"total": total, **picked}
    if args.rates and fused:
        out["rates"] = rates(torch, dev, _kernels.COARSE_TOPCAP.library, label, card)

    def stripe(rows, nseg, hi):
        lp = nseg * 128
        dist = torch.randint(0, hi, (rows, lp), dtype=torch.int32, device=dev, generator=gen)
        pos = torch.arange(lp, device=dev)
        return dist, ((pos % 128) * nseg + pos // 128).to(torch.int32)

    for rows, nseg, cap, hi in [(5, 1, 8, 40), (7, 9, 16, 2**30), (40, 513, 16, 1 << 20),
                                (3, 1563, 8, 30)]:
        dist, cols = stripe(rows, nseg, hi)
        real_l = nseg * 128 - 37
        got = distance.seg_topcap(dist, cols, cap, real_l)
        torch.cuda.synchronize()
        if not torch.equal(got, distance._seg_topcap_ref(dist, cols, cap, real_l)):
            raise AssertionError(f"[{label}] K4 {rows} {nseg} {cap}: kernel != plain")
    print(f"[{label}] K4 exact at the check shapes", flush=True)
    if fused:
        n = check_k9(torch, distance, gen, dev, label)
        print(f"[{label}] K9 exact (keys and s_min) at {n} check cases", flush=True)
    if args.quick:
        print(json.dumps(out))
        return 0

    for key, rows, nseg, cap in (("k4_flagship_ms", 16384, 512, 16),
                                 ("k4_200k_chunk_ms", 1341, 1563, 8)):
        dist, cols = stripe(rows, nseg, 1 << 20)
        real_l = nseg * 128 - 2
        ms = cuda_ms(torch, lambda: distance.seg_topcap(dist, cols, cap, real_l))
        out[key] = ms
        gb = (dist.numel() * 4 + rows * nseg * cap * 8) / 1e9
        print(f"[{label}] K4 [{rows}, {nseg * 128}] cap {cap}: {ms:.3f} ms "
              f"({gb / ms:.2f} TB/s of stripe and keys) [{card}]", flush=True)
        del dist, cols
    torch.cuda.empty_cache()

    if fused:
        from emosaic_tpu_torch.probes.k10 import clock_sample

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mhz = float(smi("clocks.max.sm"))
        fp32 = sms * 64 * mhz * 1e6  # pairs/s: 128 FP32 lanes, two FADDs a pair
        issue = sms * 128 * mhz * 1e6  # thread instructions/s: 4 warp instructions a clock
        for name, rows, nseg, dout, cap in K9_SHAPES:
            xp, cl = projected_case(torch, gen, dev, rows, nseg, dout, 32, "clustered")
            keys = torch.empty((rows, nseg * cap), dtype=torch.int64, device=dev)
            s_min = torch.empty((rows,), dtype=torch.int32, device=dev)

            def fn():
                distance.coarse_topcap(xp, cl, cap, keys, s_min)

            ms = cuda_ms(torch, fn)
            pos = rows * nseg * 128
            capl = 1 << (cap - 1).bit_length()
            ceil_ms = pos * dout / fp32 * 1e3
            floor_ms = pos * (2 * dout + 2 * capl + 4) / issue * 1e3
            out.update({f"{name}_ms": ms, f"{name}_ceiling_ms": ceil_ms,
                        f"{name}_issue_floor_ms": floor_ms})
            print(f"[{label}] K9 {rows} rows x {nseg} segments x dout {dout}, cap {cap}: "
                  f"{ms:.3f} ms; FP32 ceiling {ceil_ms:.3f} ms ({100 * ceil_ms / ms:.1f}%), "
                  f"issue floor {floor_ms:.3f} ms ({100 * floor_ms / ms:.1f}%) [{card}]",
                  flush=True)
            if name == "k9_flagship":
                clk = clock_sample(torch, fn)
                out["k9_flagship_clock"] = clk
                print(f"[{label}] while the flagship launch runs: SM clock {clk['sm_mhz']} MHz "
                      f"(min {clk.get('sm_mhz_min')}; max {mhz:.0f}), {clk['power_w']} W",
                      flush=True)
            del xp, cl, keys, s_min, fn
            torch.cuda.empty_cache()

    # the flagship coarse pass
    b, l, d, g, cap = 16384, 65534, 3072, 32, 16
    lp = -(-l // 128) * 128
    base = torch.randint(0, 256, (l, 1, 3), device=dev, generator=gen)
    lib = (base + torch.randint(-10, 11, (l, d // 3, 3), device=dev, generator=gen)
           ).clamp(0, 255).to(torch.uint8).view(l, d)
    pick = torch.randint(0, l, (b,), device=dev, generator=gen)
    blocks = (lib[pick].int() + torch.randint(-6, 7, (b, d), device=dev, generator=gen)
              ).clamp(0, 255).to(torch.uint8)
    lib_pad = distance._pad_lib(lib, lp, dev)
    del lib, base, pick
    cl = distance._ad_coarse_lib(lib_pad, d, g, True, l)

    def coarse():
        return distance._ad_coarse(blocks, cl, d, g, True, cap)

    keys, s_min = coarse()
    out["coarse_ms"] = cuda_ms(torch, coarse, reps=3)
    print(f"[{label}] coarse pass B={b} L={l} D={d} cap={cap} "
          f"({'K9' if fused else 'cdist stripe + K4'}): {out['coarse_ms']:.3f} ms [{card}]",
          flush=True)
    if fused:
        from emosaic_tpu_torch.probes.seg8 import stripe_selection

        with stripe_selection(distance.seg_topcap):
            k2, m2 = coarse()
            torch.cuda.synchronize()
            if not (torch.equal(keys, k2) and torch.equal(s_min, m2)):
                raise AssertionError(f"[{label}] K9 != cdist stripe + K4")
            out["coarse_cdist_k4_ms"] = cuda_ms(torch, coarse, reps=2)
        print(f"[{label}] coarse pass on the cdist stripe + K4: "
              f"{out['coarse_cdist_k4_ms']:.3f} ms; K9's keys and s_min bit-equal [{card}]",
              flush=True)
    del keys, s_min, cl, lib_pad, blocks
    torch.cuda.empty_cache()

    # the coarse pass's peak at a 2M-row library (flatdma's step D)
    lp2, nb, cap2 = 2_000_000, 1024, 8
    lib = torch.randint(0, 256, (lp2, d), dtype=torch.uint8, device=dev, generator=gen)
    blocks = lib[:nb].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cl = distance._ad_coarse_lib(lib, d, g, True, lp2)
    keys, s_min = distance._ad_coarse(blocks, cl, d, g, True, cap2)
    torch.cuda.synchronize()
    out["coarse_2m_peak_gb"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    print(f"[{label}] coarse pass at a {lp2}-row library, {nb} blocks, cap {cap2}: peak "
          f"{out['coarse_2m_peak_gb']:.3f} GiB above its inputs [{card}]", flush=True)
    del keys, s_min, cl, lib, blocks
    torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
