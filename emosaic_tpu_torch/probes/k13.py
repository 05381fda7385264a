#!/usr/bin/env python3
"""K13 (`csrc/row_sort.cu`), the exact-full route's per-row sort, alone on
one GPU.

    python3 emosaic_tpu_torch/probes/k13.py [--ptxas] [--quick]

It checks K13 against its plain version (`_row_sort_ref`) exactly: at the
`service_m16` cell's shape (4096 rows of 8192 distances of 768-byte rows,
u32 keys, a row a block), at the long-row edge of the route (3051 rows of
65534 distances of 3072-byte rows, u64 keys, chunks merged through device
memory), at odd row lengths (8191; 12345, u64 keys next to a block's
shared-memory limit; 30001, u32 keys on the long-row path), one-entry
rows, tie storms (three values; one value), and keys of exactly 32 and 33
bits. Distances are K10's on random bytes, or drawn where a case needs
them. Then it times, at the cell's shape and at the long-row edge:

- K13's device time (CUDA events, mean of 20 after a warm-up), beside its
  bound: the matrix read once and the output written once over 3.35 TB/s;
- its plain version's (mean of 2), and `torch.sort` of the same packed
  keys (int32 where they fit 31 bits, else int64) as the yardstick;
- at the cell's shape, on the host's clock: `sorted_lists` whole (K13, the
  lists' pageable copy to the host, the split into distances and rows),
  the copy alone, and the host sort K13 replaces (the matrix's copy, the
  stable `np.argsort`, `take_along_axis`, the casts).

`--ptxas` prints ptxas's register, shared-memory and spill report first;
`--quick` stops after the exact checks. The last line of its output is one
JSON object of the numbers, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
#: (rows, row length, row bytes D): the cell's matrix and the route's
#: longest rows (L = 65534, the reference's tile cap, at its largest B)
CELL = (4096, 8192, 768)
EDGE = (3051, 65534, 3072)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20) -> float:
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


def wall_s(torch, fn, reps: int = 3) -> float:
    """Least host seconds of fn() over `reps` runs after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def ptxas_report() -> None:
    from emosaic_tpu_torch.ops import _kernels

    k = _kernels.ROW_SORT
    r = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_kernels.BUILD_DIR / "ptxas_row_sort.so"), str(k.source)],
        capture_output=True, text=True,
    )
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln or "warning" in ln
             or "error" in ln]
    print("\n".join(lines[-60:]), flush=True)


def distances(torch, dev, gen, rows: int, n: int, d: int):
    """K10's int32 [rows, n] distances of random rows of d bytes."""
    from emosaic_tpu_torch.ops import distance

    x = torch.randint(0, 256, (rows, d), dtype=torch.uint8, device=dev, generator=gen)
    t = torch.randint(0, 256, (n, d), dtype=torch.uint8, device=dev, generator=gen)
    return distance.l1_block(x, t)


def check(torch, distance, dist, dmax: int, what: str) -> int:
    """K13 against its plain version on `dist`, exactly; returns the key bytes."""
    got = distance.row_sort(dist, dmax)
    torch.cuda.synchronize()
    want = distance._row_sort_ref(dist, dmax)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"K13 != plain: {what}")
    return distance._k13_plan(dist.shape[1], dmax)[0]


def exact_checks(torch, dev, distance) -> list[str]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    done = []

    def drawn(rows, n, lo, hi):
        return torch.randint(lo, hi + 1, (rows, n), dtype=torch.int32, device=dev, generator=gen)

    for rows, n, d in (CELL, (64, 8191, 768), (64, 12345, 3072), (16, 30001, 48), (64, 1, 768),
                       (5, 7, 3)):
        kb = check(torch, distance, distances(torch, dev, gen, rows, n, d), 255 * d,
                   f"K10's distances [{rows}, {n}], D {d}")
        path = "chunks" if distance._k13_plan(n, 255 * d)[4] else "row"
        done.append(f"[{rows}, {n}] D {d} u{8 * kb} {path}")
    for rows, n, d in ((64, 8192, 768), (8, 30001, 48), (8, 12345, 3072)):
        for lo, hi, what in ((0, 2, "three values"), (5, 5, "one value")):
            check(torch, distance, drawn(rows, n, lo, hi), 255 * d,
                  f"{what} [{rows}, {n}], D {d}")
        done.append(f"tie storms [{rows}, {n}] D {d}")
    # keys of exactly 32 bits (u32, the top bit set) and of 33 (u64)
    for dmax in ((1 << 19) - 1, 1 << 19):
        dist = drawn(32, 8192, dmax - 3, dmax)
        kb = check(torch, distance, dist, dmax, f"dmax {dmax}")
        done.append(f"[32, 8192] dmax {dmax}: u{8 * kb}")
    rows, n, d = EDGE
    dist = distances(torch, dev, gen, rows, n, d)
    kb = check(torch, distance, dist, 255 * d, f"the long-row edge [{rows}, {n}]")
    done.append(f"[{rows}, {n}] D {d} u{8 * kb} chunks")
    print("K13 exact against its plain version: " + "; ".join(done), flush=True)
    return done


def timings(torch, dev, distance, card: str) -> dict:
    import numpy as np

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    res = {}
    for name, (rows, n, d) in (("cell", CELL), ("edge", EDGE)):
        dmax = 255 * d
        dist = distances(torch, dev, gen, rows, n, d)
        plan = distance._k13_plan(n, dmax)
        kb, bits_c = plan[0], plan[1]
        keys = (dist.to(torch.int64) << bits_c) | torch.arange(n, device=dev)
        if dmax.bit_length() + bits_c <= 31:
            keys = keys.to(torch.int32)
        ms = cuda_ms(torch, lambda: distance.row_sort(dist, dmax))
        plain = cuda_ms(torch, lambda: distance._row_sort_ref(dist, dmax), reps=2)
        lib = cuda_ms(torch, lambda: torch.sort(keys, dim=1), reps=5)
        nbytes = rows * n * (4 + kb)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        r = {"shape": f"[{rows}, {n}] D {d}", "plan": list(plan), "ms": ms, "bound_ms": bound,
             "plain_ms": plain, "library_ms": lib, "library": f"torch.sort of {keys.dtype} keys"}
        print(f"K13 {name} [{rows}, {n}] D {d}, u{8 * kb} keys, plan {plan}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({100 * bound / ms:.1f}%); plain {plain:.3f} ms; torch.sort "
              f"{lib:.3f} ms [{card}]", flush=True)
        if name == "cell":
            out = distance.row_sort(dist, dmax)
            r["sorted_lists_s"] = wall_s(torch, lambda: distance.sorted_lists(dist, dmax))
            r["copy_s"] = wall_s(torch, lambda: out.cpu())

            def host_sort():
                m = dist.cpu().numpy()
                cr = np.argsort(m, axis=1, kind="stable").astype(np.int32)
                np.take_along_axis(m, cr, axis=1).astype(np.int32)

            r["host_sort_s"] = wall_s(torch, host_sort, reps=1)
            print(f"K13 cell on the host's clock: sorted_lists {r['sorted_lists_s']:.4f} s (the "
                  f"copy alone {r['copy_s']:.4f} s); the host sort it replaces "
                  f"{r['host_sort_s']:.3f} s [{card}]", flush=True)
        res[name] = r
        del dist, keys
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("k13: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _kernels.build_all((_kernels.ROW_SORT, _kernels.L1_STRIPE))
    print(f"built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if args.ptxas:
        ptxas_report()
    res = {"card": card, "exact": exact_checks(torch, dev, distance)}
    if not args.quick:
        res.update(timings(torch, dev, distance, card))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
