"""A tiny copy of the benchmark for CPU tests: the same files, every
configuration cut to a few hundred tiles and small photos, run on the
CPU with the program's plain versions."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_torch import spec

HERE = spec.HERE
#: the tiny sizes: (mode, tile size, tiles, photo height, photo width) by
#: configuration
TINY = {"generate_m32": (8, 8, 300, 128, 128), "cli_m4": (4, 8, 300, 192, 256)}


def make(tmp: Path) -> spec.Benchmark:
    """Copy the benchmark under tmp with tiny configurations; returns it
    loaded (its files under tmp/bench_torch)."""
    shutil.copytree(HERE, tmp / "bench_torch",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    raw = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for c in raw["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        mode, ts, tiles, h, w = TINY[c["name"]]
        cfg.update(mode=mode, tile_size=ts, tiles=tiles, source_height=h, source_width=w)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(raw))
    return spec.load_benchmark(tmp / "BENCHMARK.json")


def run(bench, cell: str, seed: int = 2**31 + 5, seconds: float = 0.3, trace=False):
    from bench_torch import harness

    return harness.run_cell(bench, cell, seed=seed, seconds=seconds, trace=trace,
                            device="cpu", base=bench.root / "bench_torch")
