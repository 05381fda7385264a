#!/usr/bin/env python3
"""Host-to-device upload rates on one GPU: pageable against registered.

    python3 emosaic_tpu_torch/probes/h2d.py [--reps N]

At the sizes of the library uploads the benchmark's cells make (100.7 MB:
32767 palettes or tiles at mode 32 and tile size 32; 307.2 MB: 100000 of
them) it times, on the host's clock from the call to the upload done
(median of `--reps` after one warm-up), uploads of one host array that
stays alive, as the library's arrays do:

- `pageable`: `torch.from_numpy(a).to(dev)` of plain memory (the pages
  are faulted in already: CUDA stages the copy through its own buffer);
- `registered`: the same call after the array's memory was page-locked
  in place (`ops.copies._PAGES.register`, libcuda's
  `cuMemHostRegister`, portable);
- `helper`: `ops.copies.to_device_kept` once registered, where the
  checkout has it;
- `pin_memory`: from a page-locked copy made by `Tensor.pin_memory()`
  beforehand, for the link's rate from torch's own allocator.

Then the cost of one registration and one unregistration at each size
(median of `--reps`, each on the array's resident pages). The last line
of its output is one JSON object of the numbers, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: (label, bytes): the library uploads of the cells
SIZES = (
    ("100.7MB", 32767 * 1024 * 3),
    ("307.2MB", 100000 * 1024 * 3),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def median_s(torch, fn, reps: int, warm: bool = True) -> float:
    """Median host seconds of fn() over `reps` runs (after a warm-up if
    `warm`); each run starts with the device idle and ends synced."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no GPU: the probe measures the card's uploads", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import copies

    helper = getattr(copies, "to_device_kept", None)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    card = card_line()
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "sizes": {}}
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda} [{card}]", flush=True)

    for label, nbytes in SIZES:
        a = np.random.default_rng(nbytes).integers(0, 256, size=nbytes, dtype=np.uint8)
        want = torch.from_numpy(a).to(dev)
        row = {"bytes": nbytes}

        def upload():
            return torch.from_numpy(a).to(dev)

        def timed(name, fn):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} at {label}: bytes differ")
            s = median_s(torch, fn, args.reps)
            row[f"{name}_ms"] = s * 1e3
            row[f"{name}_gb_s"] = nbytes / s / 1e9

        timed("pageable", upload)
        ptr = a.ctypes.data
        reg, unreg = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            ok = copies._PAGES.register(ptr, nbytes, dev)
            reg.append(time.perf_counter() - t0)
            if not ok:
                raise AssertionError(f"registration failed at {label}")
            if not torch.from_numpy(a).is_pinned():
                raise AssertionError(f"registered memory at {label} is not page-locked")
            t0 = time.perf_counter()
            ok = copies._PAGES.unregister(ptr, dev)
            unreg.append(time.perf_counter() - t0)
            if not ok:
                raise AssertionError(f"unregistration failed at {label}")
        row["register_ms"] = statistics.median(reg) * 1e3
        row["unregister_ms"] = statistics.median(unreg) * 1e3
        copies._PAGES.register(ptr, nbytes, dev)
        timed("registered", upload)
        copies._PAGES.unregister(ptr, dev)
        if helper is not None:
            timed("helper", lambda: helper(a, dev))  # registers on its first call
        pinned = torch.from_numpy(a).pin_memory()
        timed("pin_memory", lambda: pinned.to(dev))
        res["sizes"][label] = row
        print(f"{label}: " + ", ".join(
            f"{k[:-3]} {row[k]:.3f} ms" + (f" ({row[k[:-3] + '_gb_s']:.2f} GB/s)"
                                           if k[:-3] + "_gb_s" in row else "")
            for k in row if k.endswith("_ms")), flush=True)
        del a, want, pinned
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
