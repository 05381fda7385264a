"""Run one cell of the port's benchmark on the card and print its result.

    python bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. With `--trace 0` the last line of standard
output is the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics, the device's busy time and a breakdown of the trace. Each number
that decides `correct` is printed beside its limit as the last lines of
standard error and under `checks`, the last key of the result. Exits with
2 and prints no result when no CUDA card, or fewer than the cell asks for,
is visible.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: kernel and build caches, at fixed paths inside the checkout
CACHES = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
    "CUDA_CACHE_PATH": "nv_compute",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from bench_torch import spec

    bench = spec.load_benchmark(ROOT / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from bench_torch import harness

    result = harness.run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t_start=T_START)
    harness.print_checks(result)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
