"""The control of `correct`: the plain reference put in the program's place,
with every byte cut to its top 4 bits before the distances (int4 in
place of the configuration's exact u8 L1), run through the harness's own
window and comparison. It has to come out as not correct; its readings
are the upper ends of the limits in PERF.md.

    python bench_torch/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]

Prints one JSON line a seed with the numbers compared. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
#: the control's precision: the top 4 bits of each byte
BITS = 4


def control_entry(base: Path, bits: int = BITS):
    """A stand-in for `harness.entry`: each render is the configuration's
    reference (`semantics/` under `base`) at `bits` bits, shaped like the
    program's outcome."""
    import torch

    from bench_torch import harness

    def make(cfg, tile_set, stack, device):
        pal = torch.from_numpy(tile_set.palettes).to(device)
        tiles = torch.from_numpy(stack).to(device)
        sem = harness.semantics(cfg, base)

        def render(src):
            items, image = sem.render(torch.from_numpy(src).to(device), pal, tiles, cfg, bits)
            return SimpleNamespace(items=items.cpu().numpy(), image=image.cpu().numpy(),
                                   info={})

        return render

    return make


def run(bench, cell: str, seeds, seconds: float, device: str, base=None):
    """[(seed, result)] of the control's runs."""
    from bench_torch import harness, spec

    base = base or spec.HERE
    real = harness.entry
    harness.entry = control_entry(base)
    try:
        return [(s, harness.run_cell(bench, cell, seed=s, seconds=seconds, trace=False,
                                     device=device, base=base))
                for s in seeds]
    finally:
        harness.entry = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import spec

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, res in run(bench, args.workload, seeds, args.seconds, "cuda"):
        print(json.dumps({"control": args.workload, "seed": seed, "bits": BITS,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
