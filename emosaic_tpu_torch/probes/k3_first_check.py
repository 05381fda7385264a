#!/usr/bin/env python3
"""The first check of kernel K3 (`csrc/l1_rows.cu`) on a GPU, and the
library timings its design rests on.

    python3 emosaic_tpu_torch/probes/k3_first_check.py

Builds the three kernels (printing ptxas's register and spill report for
K3), holds K3 against `_l1_rows_ref` at six shapes (D = 3 to 49152,
candidates past L clamped), then times with CUDA events: K3 at the
flagship no-repeat shape (B=16384, m=1024, D=3072, L=65534, random
candidates), `torch.cdist(p=1)` at the full-D and coarse (D=96) stripe
shapes, and the two-level scorer's segment top-k. Prints the card's
name and power limit first. `chip_smoke.py` repeats the checks and the
K3 and full-D cdist timings on every run.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from emosaic_tpu_torch.ops import _kernels, distance  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip())
    t0 = time.time()
    print(_kernels.build_all(force=True), time.time() - t0)
    r = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_kernels.BUILD_DIR / "ptxas_check.so"), str(_kernels.L1_ROWS.source)],
        capture_output=True, text=True,
    )
    print(r.stdout[-3000:], r.stderr[-3000:])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)

    for b, l, d, m in [(3, 50, 3, 7), (5, 300, 12, 64), (4, 1000, 48, 1024),
                       (2, 100, 49152, 7), (64, 5000, 3072, 1024), (17, 2000, 75, 33)]:
        blocks, lib = u8((b, d)), u8((l, d))
        cand = torch.randint(0, l + 5, (b, m), dtype=torch.int32, device=dev, generator=g)
        cand[:, 0], cand[:, -1] = 0, l - 1
        got = distance.l1_rows(blocks, cand, lib)
        torch.cuda.synchronize()
        want = distance._l1_rows_ref(blocks, cand, lib)
        print(b, l, d, m, "max err", int((got.long() - want.long()).abs().max()))
    print("launches", _kernels.L1_ROWS.launches)

    st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def ms(fn, reps=1):
        fn()
        torch.cuda.synchronize()
        st.record()
        for _ in range(reps):
            fn()
        en.record()
        torch.cuda.synchronize()
        return st.elapsed_time(en) / reps

    b, l, d, m = 16384, 65534, 3072, 1024
    blocks, lib = u8((b, d)), u8((l, d))
    cand = torch.randint(0, l, (b, m), dtype=torch.int32, device=dev, generator=g)
    got = distance.l1_rows(blocks, cand, lib)
    s = torch.arange(0, b, 64, device=dev)
    want = distance._l1_rows_ref(blocks[s], cand[s], lib)
    print("flagship sample err", int((got[s].long() - want.long()).abs().max()))
    print("K3 flagship ms", ms(lambda: distance.l1_rows(blocks, cand, lib), 5))
    x, t = blocks[:4096].float(), lib.float()
    print("cdist 4096x65534x3072 ms", ms(lambda: torch.cdist(x, t, p=1)))
    xp = torch.randint(0, 8000, (4096, 96), device=dev).float()
    tp = torch.randint(0, 8000, (65536, 96), device=dev).float()
    print("cdist 4096x65536x96 ms", ms(lambda: torch.cdist(xp, tp, p=1)))
    k = torch.randint(0, 2**40, (4096, 65536), device=dev)
    print("segment topk(16) of [4096, 512, 128] ms",
          ms(lambda: torch.topk(k.view(4096, 512, 128), 16, dim=2, largest=False)))
    print("topk(512) of [4096, 65536] ms", ms(lambda: torch.topk(k, 512, dim=1, largest=False)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
