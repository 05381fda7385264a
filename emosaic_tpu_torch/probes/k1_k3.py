#!/usr/bin/env python3
"""K1 (`csrc/l1_argmin.cu`) and K3 (`csrc/l1_rows.cu`) on one GPU: exact
against their plain versions, then timed at the main paths' shapes.

    python3 emosaic_tpu_torch/probes/k1_k3.py [--root DIR] [--ptxas] [--label NAME]

`--root` imports `emosaic_tpu_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked into a git-ignored directory),
so two versions of the kernels are timed by the same script on the same
card: run it as parent, change, change, parent on one card. The
kernels of that checkout are built there, from its own sources.
`--ptxas` prints ptxas's register, shared-memory and spill report for the
two sources first.

It checks K1 at small shapes, on a tie storm and on a library split
across blocks; K3 at D 3..3072 on both of its paths with repeated,
clamped and unsorted candidates. It then times with CUDA events (mean of
several launches after a warm-up):

- K1 at the repeat main path's mode-4 shape (B=262144, L=200000, D=48)
  and at B=4096, L=200000 for D in (12, 48, 192, 768, 3072), in T byte
  pairs per second;
- K3 at the flagship no-repeat shape (B=16384, m=1024, D=3072, L=65534)
  on random candidates, and on the adaptive scorer's own candidate lists
  of a clustered flagship scene (32767 tiles with +-10 texture, blocks
  = tiles + +-6 noise), with the reuse: (query, candidate) pairs per
  distinct row in groups of 16 queries, consecutive and in the order of
  K3's grouped path (by each list's least row).

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


def reuse(torch, cand, group: int = 16, minhash: bool = False) -> float:
    """(query, candidate) pairs per distinct row within groups of `group`
    consecutive queries; with `minhash`, in K3's grouped order (queries
    sorted by their least candidate row)."""
    if minhash:
        cand = cand[cand.min(dim=1).values.argsort(stable=True)]
    b, m = cand.shape
    nb = b // group * group
    s = cand[:nb].reshape(-1, group * m).sort(dim=1).values
    distinct = int((s[:, 1:] != s[:, :-1]).sum()) + s.shape[0]
    return nb * m / distinct


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
        print("k1_k3: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    card = card_line()
    label = args.label or str(root)
    print(f"[{label}] {card}", flush=True)
    t0 = time.perf_counter()
    secs = _kernels.build_all((_kernels.L1_ARGMIN, _kernels.L1_ROWS), force=True)
    print(f"[{label}] built {secs} in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.ptxas:
        for k in (_kernels.L1_ARGMIN, _kernels.L1_ROWS):
            r = subprocess.run(
                [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(_kernels.BUILD_DIR / f"ptxas_{k.name}.so"), str(k.source)],
                capture_output=True, text=True,
            )
            lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling" in ln]
            print("\n".join(lines[-80:]), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def same(got, want, what):
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[{label}] {what}: kernel != plain")

    # K1 exactness
    for b, l, d in [(1, 3, 3), (300, 513, 12), (70, 100, 200), (257, 1000, 192),
                    (33, 50, 75), (600, 7000, 48), (40, 3000, 64), (40, 3000, 68),
                    (9, 400, 3072)]:
        x, t = u8((b, d)), u8((l, d))
        same(distance.l1_argmin(x, t), distance.l1_argmin_ref(x, t), f"K1 {b} {l} {d}")
    base = u8((500, 48))
    pick = torch.randint(0, 500, (300,), device=dev, generator=gen)
    dist, row = distance.l1_argmin(base[pick], base.repeat(7, 1))
    torch.cuda.synchronize()
    if not (bool((dist == 0).all()) and torch.equal(row, pick.to(torch.int32))):
        raise AssertionError(f"[{label}] K1 tie storm: not the lowest row")
    # K3 exactness: both paths, repeated, clamped and unsorted candidates
    for b, l, d, m in [(3, 50, 3, 1), (5, 300, 12, 7), (40, 1000, 48, 64),
                       (9, 700, 192, 33), (37, 900, 768, 1024), (33, 2000, 3072, 64),
                       (70, 500, 3072, 300)]:
        x, t = u8((b, d)), u8((l, d))
        c = torch.randint(-2, l + 3, (b, m), dtype=torch.int32, device=dev, generator=gen)
        if m > 3:
            c[:, 1] = c[:, 3]
        same((distance.l1_rows(x, c, t),), (distance._l1_rows_ref(x, c, t),),
             f"K3 {b} {l} {d} {m}")
    print(f"[{label}] K1 and K3 exact at the check shapes", flush=True)

    out = {"label": label, "card": card}
    # K1: the main path's shape and the D sweep
    b, l, d = 262144, 200000, 48
    x, t = u8((b, d)), u8((l, d))
    ms = cuda_ms(torch, lambda: distance.l1_argmin(x, t), reps=5)
    out["k1_main_ms"] = ms
    print(f"[{label}] K1 B={b} L={l} D={d}: {ms:.3f} ms, "
          f"{b * l * d / ms / 1e9:.2f} T byte pairs/s [{card}]", flush=True)
    del x, t
    sweep = {}
    for d in (12, 48, 192, 768, 3072):
        x, t = u8((4096, d)), u8((200000, d))
        ms = cuda_ms(torch, lambda: distance.l1_argmin(x, t), reps=3)
        sweep[d] = ms
        print(f"[{label}] K1 B=4096 L=200000 D={d}: {ms:.3f} ms, "
              f"{4096 * 200000 * d / ms / 1e9:.2f} T byte pairs/s [{card}]", flush=True)
        del x, t
    out["k1_sweep_ms"] = sweep
    torch.cuda.empty_cache()

    # K3: random candidates at the flagship shape
    b, l, d, m = 16384, 65534, 3072, 1024
    x, t = u8((b, d)), u8((l, d))
    c = torch.randint(0, l, (b, m), dtype=torch.int32, device=dev, generator=gen)
    s = torch.arange(0, b, 64, device=dev)
    same((distance.l1_rows(x, c, t)[s],), (distance._l1_rows_ref(x[s], c[s], t),),
         "K3 flagship random")
    ms = cuda_ms(torch, lambda: distance.l1_rows(x, c, t))
    out["k3_random_ms"], out["k3_random_reuse"] = ms, reuse(torch, c)
    out["k3_random_reuse_minhash"] = reuse(torch, c, minhash=True)
    print(f"[{label}] K3 B={b} m={m} D={d} L={l} random: {ms:.3f} ms; reuse "
          f"{out['k3_random_reuse']:.3f} in consecutive groups of 16, "
          f"{out['k3_random_reuse_minhash']:.3f} in min-hash order [{card}]", flush=True)
    del x, t, c
    torch.cuda.empty_cache()

    # K3: the adaptive scorer's own lists on a clustered flagship scene
    tiles, cells = 32767, 1024
    pal = (torch.randint(0, 256, (tiles, 1, 3), device=dev, generator=gen)
           + torch.randint(-10, 11, (tiles, cells, 3), device=dev, generator=gen)
           ).clamp(0, 255).to(torch.uint8)
    pick = torch.randint(0, tiles, (16384,), device=dev, generator=gen)
    noise = torch.randint(-6, 7, (16384, cells, 3), device=dev, generator=gen)
    blocks = (pal[pick].int() + noise).clamp(0, 255).to(torch.uint8).reshape(16384, -1)
    lib = distance.build_library(pal)
    seen = []
    real = distance.l1_rows

    def capture(xx, cc, tt):
        seen.append((xx, cc, tt))
        return real(xx, cc, tt)

    distance.l1_rows = capture
    try:
        distance.l1_topk_adaptive(blocks, lib, 512)
    finally:
        distance.l1_rows = real
    xx, cc, tt = max(seen, key=lambda s_: s_[1].numel())
    s = torch.arange(0, xx.shape[0], 16, device=dev)
    same((real(xx, cc, tt)[s],), (distance._l1_rows_ref(xx[s], cc[s], tt),),
         "K3 flagship lists")
    ms = cuda_ms(torch, lambda: real(xx, cc, tt))
    out["k3_lists_ms"], out["k3_lists_reuse"] = ms, reuse(torch, cc)
    out["k3_lists_reuse_minhash"] = reuse(torch, cc, minhash=True)
    out["k3_lists_shape"] = list(cc.shape)
    print(f"[{label}] K3 on the adaptive scorer's lists {list(cc.shape)} D={xx.shape[1]}: "
          f"{ms:.3f} ms; reuse {out['k3_lists_reuse']:.3f} in consecutive groups of 16, "
          f"{out['k3_lists_reuse_minhash']:.3f} in min-hash order [{card}]", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
