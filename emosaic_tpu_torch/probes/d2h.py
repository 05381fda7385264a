#!/usr/bin/env python3
"""Device-to-host copy rates on one GPU: pageable against page-locked.

    python3 emosaic_tpu_torch/probes/d2h.py [--reps N]

At the sizes the benchmark's cells copy (1 MiB; 12.6 MB, a 2048² image;
134 MB, the `service_m16` sorted keys; 201 MB, an 8192² image or a
65534 x 3072 library; 251 MB, the `generate_m32` blocks and library) it
times, on the host's clock from the call to the host array in hand
(median of `--reps` after one warm-up):

- `pageable`: `x.cpu().numpy()`, a fresh pageable array each time;
- `pageable_reused`: a copy into one pageable host tensor made once, so
  the pages are faulted in already: what is left is CUDA's staging copy;
- `pinned`: a block from torch's caching host allocator
  (`torch.empty(..., pin_memory=True)`, the block returned to the cache
  each time), `copy_(x, non_blocking=True)`, one sync of the stream;
- `helper`: `ops.copies.to_host`, where the checkout has it.

Then one fresh page-locked allocation of 256 MB (a size bucket the cache
has not seen), and a sweep from 4 KiB to 16 MiB for the crossover: the
least size from which the page-locked copy is faster at every size swept,
raw and through the helper's page-locked route (its size rule set to 0
for the sweep), which sets `copies.PINNED_MIN_BYTES`.
The last line of its output is one JSON object of the numbers, with the
card's name and power limit and what the installed torch reports of its
host allocator.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MB = 10**6
#: (label, bytes): the cells' bulk copies
SIZES = (
    ("1MiB", 1 << 20),
    ("12.6MB", 2048 * 2048 * 3),
    ("134MB", 4096 * 8192 * 4),
    ("201MB", 8192 * 8192 * 3),
    ("251MB", 16384 * 3072 + 65534 * 3072),
)
SWEEP = tuple(1 << p for p in range(12, 25))  # 4 KiB .. 16 MiB


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def median_s(torch, fn, reps: int) -> float:
    """Median host seconds of fn() over `reps` runs after a warm-up; each
    run starts with the device idle and ends with the array on the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def routes(torch, x, helper):
    """{name: fn} of the ways to bring x to the host."""
    stream = torch.cuda.current_stream(x.device)
    reused = torch.empty(x.shape, dtype=x.dtype)

    def pageable():
        return x.cpu().numpy()

    def pageable_reused():
        reused.copy_(x)
        return reused.numpy()

    def pinned():
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        stream.synchronize()
        return buf.numpy()

    out = {"pageable": pageable, "pageable_reused": pageable_reused, "pinned": pinned}
    if helper is not None:
        out["helper"] = lambda: helper(x)
    return out


def host_allocs(torch) -> int | None:
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("num_host_alloc")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no GPU: the probe measures the card's copies", file=sys.stderr)
        return 1
    try:
        from emosaic_tpu_torch.ops import copies
    except ImportError:
        copies = None
    helper = None if copies is None else copies.to_host
    dev = torch.device("cuda", 0)
    card = card_line()
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "host_memory_stats": hasattr(torch.cuda, "host_memory_stats")}
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda} [{card}]", flush=True)

    # one fresh page-locked allocation: 256 MB is a bucket nothing used yet
    torch.empty(1, dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    fresh = torch.empty(256 * MB, dtype=torch.uint8, pin_memory=True)
    res["fresh_pin_256MB_s"] = time.perf_counter() - t0
    del fresh
    print(f"fresh page-locked 256 MB: {res['fresh_pin_256MB_s'] * 1e3:.1f} ms", flush=True)

    res["sizes"] = {}
    for label, nbytes in SIZES:
        x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
        want = x.cpu().numpy()
        row = {"bytes": nbytes}
        for name, fn in routes(torch, x, helper).items():
            if not np.array_equal(fn(), want):
                raise AssertionError(f"{name} at {label}: bytes differ")
            s = median_s(torch, fn, args.reps)
            row[f"{name}_ms"] = s * 1e3
            row[f"{name}_gb_s"] = nbytes / s / 1e9
        res["sizes"][label] = row
        print(f"{label}: " + ", ".join(
            f"{k[:-3]} {row[k]:.3f} ms ({row[k[:-3] + '_gb_s']:.2f} GB/s)"
            for k in row if k.endswith("_ms")), flush=True)
        del x, want

    sweep = {}
    names = ("pageable", "pinned") + (("helper",) if helper else ())
    if copies is not None:
        least, copies.PINNED_MIN_BYTES = copies.PINNED_MIN_BYTES, 0  # its page-locked route
    for nbytes in SWEEP:
        x = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
        r = routes(torch, x, helper)
        sweep[nbytes] = {name: median_s(torch, r[name], 4 * args.reps) * 1e3 for name in names}
        print(f"sweep {nbytes} B: " + ", ".join(
            f"{name} {sweep[nbytes][name]:.4f} ms" for name in names), flush=True)
    if copies is not None:
        copies.PINNED_MIN_BYTES = least
    res["sweep_ms"] = sweep

    def crossover(name):
        wins = [n for n in SWEEP if sweep[n][name] < sweep[n]["pageable"]]
        return next((n for n in SWEEP if all(m in wins for m in SWEEP if m >= n)), None)

    res["crossover_bytes"] = crossover("pinned")
    if helper:
        res["helper_crossover_bytes"] = crossover("helper")
    res["host_allocs"] = host_allocs(torch)
    print(f"crossover: {res['crossover_bytes']} B (the helper's page-locked route: "
          f"{res.get('helper_crossover_bytes')} B); page-locked blocks allocated "
          f"{res['host_allocs']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
