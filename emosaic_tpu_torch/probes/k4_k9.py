#!/usr/bin/env python3
"""K4 (`csrc/seg_topcap.cu`) alone and the adaptive scorer's coarse pass
(K9, `csrc/coarse_topcap.cu`, and the cdist stripe + K4) on one GPU.

    python3 emosaic_tpu_torch/probes/k4_k9.py [--root DIR] [--ptxas] [--label NAME]

`--root` imports `emosaic_tpu_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked into a git-ignored directory),
so two versions are timed by the same script on the same card: run it as
parent, change, change, parent in one call. The kernels of that checkout
are built there, from its own sources; a checkout without K9 times its
coarse pass as it is (the cdist stripe + K4). `--ptxas` prints ptxas's
register, shared-memory and spill report of K4 and K9 first.

It checks K4 against `_seg_topcap_ref` at small shapes, then times with
CUDA events (mean of several launches after a warm-up):

- K4 on the flagship coarse stripe [16384, 65536] int32 at cap 16 and on
  the 200k-shape chunk [1341, 200064] at cap 8 (`probes/seg8.py`);
- the coarse pass `_ad_coarse` at the flagship shape (B=16384 blocks
  against L=65534 rows of D=3072, g=32 per channel, cap 16) on random
  palettes, with K9, and with the cdist stripe + K4 (both bit-equal);
- the peak device bytes of `_ad_coarse_lib` + `_ad_coarse` at a 2M-row
  library (D=3072, 1024 blocks, cap 8), as `probes/flatdma.py` step D.

The last line of its output is one JSON object of the numbers, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k4_k9: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    card = card_line()
    label = args.label or str(root)
    fused = hasattr(distance, "coarse_topcap")
    kernels = [_kernels.SEG_TOPCAP] + ([_kernels.COARSE_TOPCAP] if fused else [])
    print(f"[{label}] {card}", flush=True)
    t0 = time.perf_counter()
    secs = _kernels.build_all(tuple(kernels), force=True)
    print(f"[{label}] built {secs} in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.ptxas:
        for k in kernels:
            r = subprocess.run(
                [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(_kernels.BUILD_DIR / f"ptxas_{k.name}.so"), str(k.source)],
                capture_output=True, text=True,
            )
            lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling" in ln]
            print("\n".join(lines[-40:]), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

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

    out = {"label": label, "card": card, "k9": fused}
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
