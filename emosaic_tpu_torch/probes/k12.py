#!/usr/bin/env python3
"""K12 (`csrc/masked_refill.cu`), the no-repeat engine's masked refill,
alone on one GPU, against the chain it replaces below the crossover.

    python3 emosaic_tpu_torch/probes/k12.py [--ptxas] [--quick] [--profile] [--sweep M,M,...]

It checks K12 against its plain version (`_masked_refill_ref`) at small
shapes and at the `generate_m32` refill's shape, then times, at that
shape (65534 library rows of 3072 bytes, 37k of them unused, k = 256),
for each M of the sweep (default 1, 2, 4, 8, 16, 32, 64, 96, 128, 256,
512, 1024, 2048 and 4096 blocks, the refiller's largest batch):

- K12's device time (CUDA events, mean of 20 after a warm-up);
- the old chain's device time: the gather of the unused rows, K10's
  stripe, the packed-key `torch.topk` and the rows' lookup
  (`_refill_topk` without its copies to the host);
- a whole refill call on the host's clock, host work included, through
  `DeviceRefiller` on each route (the mask and ids up, the call, dists and
  rows back): `_K12_MAX_M` patched to each side of M;

each beside K12's bound (the unused rows' bytes, the mask and the queried
blocks over 3.35 TB/s) and its ceiling (the byte pairs over the VABSDIFF4
rate, 132 SMs x 64 lanes x 4 pairs x 1980 MHz), the larger of the two
being the least time. The measured crossover is the largest M of the
sweep up to which a call on K12 beats a call on the stripe's route at
every M of the sweep. `--ptxas` prints ptxas's register, shared-memory
and spill report first; `--profile` adds each kernel's device time at M
= 1 and 4 (torch.profiler) and the host's enqueue time of each step of a
call; `--quick` stops after the exact checks. The last
line of its output is one JSON object of the numbers, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

L, D, K, UNUSED = 65534, 3072, 256, 37000
HBM_BYTES_PER_S = 3.35e12
VABSDIFF4_PAIRS_PER_S = 132 * 64 * 4 * 1980e6
SWEEP = (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 512, 1024, 2048, 4096)


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


def ptxas_report() -> None:
    from emosaic_tpu_torch.ops import _kernels

    k = _kernels.MASKED_REFILL
    r = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_kernels.BUILD_DIR / "ptxas_masked_refill.so"), str(k.source)],
        capture_output=True, text=True,
    )
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln or "warning" in ln
             or "error" in ln]
    print("\n".join(lines[-40:]), flush=True)


def scene(torch, dev, seed: int = 12):
    """The library, 4096 blocks and a mask leaving UNUSED rows, on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lib = torch.randint(0, 256, (L, D), dtype=torch.uint8, device=dev, generator=gen)
    blocks = torch.randint(0, 256, (4096, D), dtype=torch.uint8, device=dev, generator=gen)
    used = torch.ones(L, dtype=torch.uint8, device=dev)
    used[torch.randperm(L, device=dev, generator=gen)[:UNUSED]] = 0
    return gen, lib, blocks, used


def exact_checks(torch, dev, refill) -> None:
    gen, lib, blocks, used = scene(torch, dev)
    for m in (1, 4, refill._K12_MAX_M + 1):
        ids = torch.randperm(4096, device=dev, generator=gen)[:m]
        got = refill.masked_refill(blocks, ids, lib, used, K)
        torch.cuda.synchronize()
        want = refill._masked_refill_ref(blocks, ids, lib, used, K)
        if not torch.equal(got, want):
            raise AssertionError(f"K12 != plain at the cell's shape, M={m}")
    for l, d in ((1034, 24), (129, 48), (5000, 3088), (300, 4112)):
        t = torch.randint(0, 256, (l, d), dtype=torch.uint8, device=dev, generator=gen)
        x = torch.randint(0, 256, (70, d), dtype=torch.uint8, device=dev, generator=gen)
        for m in (1, 3, 64):
            ids = torch.randperm(70, device=dev, generator=gen)[:m]
            for frac in (0.0, 0.5, 1.0):
                u = (torch.rand(l, device=dev, generator=gen) < frac).to(torch.uint8)
                for k in (1, 16, 256):
                    got = refill.masked_refill(x, ids, t, u, k)
                    torch.cuda.synchronize()
                    if not torch.equal(got, refill._masked_refill_ref(x, ids, t, u, k)):
                        raise AssertionError(f"K12 != plain at L={l} D={d} M={m} k={k}")
    print(f"K12 exact against its plain version: the cell's shape at M 1, 4, "
          f"{refill._K12_MAX_M + 1}; L 129..5000, D 24..4112, M 1..64, masks none/half/all, "
          "k 1..256", flush=True)


def sweep(torch, dev, refill, ms) -> list[dict]:
    import numpy as np

    from emosaic_tpu_torch.ops.distance import _topk_rows, l1_block

    gen, lib, blocks, used = scene(torch, dev)
    used_h = used.cpu().numpy()
    unused = torch.nonzero(used == 0).flatten()
    out = []
    for m in ms:
        ids = torch.randperm(4096, device=dev, generator=gen)[:m]
        k12 = cuda_ms(torch, lambda: refill.masked_refill(blocks, ids, lib, used, K))

        def chain():
            sub = lib.index_select(0, unused)
            dist = l1_block(blocks.index_select(0, ids), sub)
            dd, pos = _topk_rows(dist, K)
            return dd, unused[pos.to(torch.int64)]

        old = cuda_ms(torch, chain, reps=10)
        ids_h = ids.cpu().numpy().astype(np.int64)
        walls = {}
        keep = refill._K12_MAX_M
        try:
            for route, cap in (("k12", 1 << 30), ("stripe", 0)):
                refill._K12_MAX_M = cap
                refiller = refill.DeviceRefiller(blocks, lib, k=K)
                refiller(ids_h, used_h)  # staging buffers, warm
                t0 = time.perf_counter()
                for _ in range(20):
                    refiller(ids_h, used_h)
                walls[route] = (time.perf_counter() - t0) / 20 * 1e3
        finally:
            refill._K12_MAX_M = keep
        nbytes = UNUSED * D + L + m * D + 2 * m * K * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ceiling = m * UNUSED * D / VABSDIFF4_PAIRS_PER_S * 1e3
        row = {"m": m, "k12_ms": k12, "chain_ms": old, "call_k12_ms": walls["k12"],
               "call_stripe_ms": walls["stripe"], "bound_ms": bound, "ceiling_ms": ceiling,
               "least_ms": max(bound, ceiling)}
        out.append(row)
        print(f"M={m:4d}: K12 {k12:.4f} ms, chain {old:.4f} ms; a call on K12 "
              f"{walls['k12']:.4f} ms, on the stripe {walls['stripe']:.4f} ms; bound "
              f"{bound:.4f} ms, ceiling {ceiling:.4f} ms ({100 * max(bound, ceiling) / k12:.1f}% "
              "of the least time)", flush=True)
    return out


def measured_crossover(rows: list[dict]) -> int | None:
    """The largest M of `sweep`'s rows up to which a whole call on K12
    beats one on the stripe's route at every M measured; None where K12
    loses at the least M."""
    best = None
    for r in sorted(rows, key=lambda r: r["m"]):
        if r["call_k12_ms"] >= r["call_stripe_ms"]:
            break
        best = r["m"]
    return best


def profile(torch, dev, refill, ms=(1, 4)) -> dict:
    """Device time by kernel (torch.profiler) of 20 K12 calls at each M,
    and the host's share of a refill call: each step's enqueue, mean of
    200 back to back."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as prof

    gen, lib, blocks, used = scene(torch, dev)
    out = {}
    for m in ms:
        ids = torch.randperm(4096, device=dev, generator=gen)[:m]
        refill.masked_refill(blocks, ids, lib, used, K)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(20):
                refill.masked_refill(blocks, ids, lib, used, K)
            torch.cuda.synchronize()
        by = {}
        for e in p.key_averages():
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if t and "kernel" in e.key:
                by[e.key[:60]] = t / 20 / 1e3
        out[f"m{m}_device_ms"] = by
        print(f"M={m}: device ms a call by kernel {by}", flush=True)
    used_h = used.cpu().numpy()
    ids_h = np.arange(1, dtype=np.int64)
    refiller = refill.DeviceRefiller(blocks, lib, k=K)
    refiller(ids_h, used_h)
    up_h, up_d, work, off = refiller._up_h, refiller._up_d, refiller._work, refiller._off
    u_h, ptr = refiller._used_h, refiller._up_d.data_ptr()
    steps = {
        "copyto_count": lambda: (np.copyto(u_h, used_h, casting="unsafe"),
                                 np.count_nonzero(used_h)),
        "h2d_enqueue": lambda: up_d[:off + 8].copy_(up_h[:off + 8], non_blocking=True),
        "k12_launch_enqueue": lambda: refill._k12_launch(
            refiller._blocks, refiller._lib, ptr + off, ptr, work, 1, K, refiller._plan),
        "masked_refill_enqueue": lambda: refill.masked_refill(
            refiller._blocks, up_d[off:off + 8].view(torch.int64), refiller._lib, up_d[:L], K),
        "whole_call": lambda: refiller(ids_h, used_h),
    }
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[f"host_{name}_ms"] = (t1 - t0) / 200 * 1e3
        print(f"host {name}: {out[f'host_{name}_ms']:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ptxas", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--sweep", default=",".join(map(str, SWEEP)))
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("k12: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, refill

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _kernels.build_all((_kernels.MASKED_REFILL, _kernels.L1_STRIPE))
    print(f"built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if args.ptxas:
        ptxas_report()
    exact_checks(torch, dev, refill)
    res = {"card": card, "k12_max_m": refill._K12_MAX_M}
    if args.profile:
        res["profile"] = profile(torch, dev, refill)
    if not args.quick:
        res["sweep"] = sweep(torch, dev, refill, [int(m) for m in args.sweep.split(",")])
        res["crossover_measured"] = measured_crossover(res["sweep"])
        print(f"measured crossover: M = {res['crossover_measured']} (the code's "
              f"`_K12_MAX_M` {refill._K12_MAX_M}) [{card}]", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
