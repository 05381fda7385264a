"""One run of one cell: set-up, warm-up, the measured window, the metrics
and the check of every render against the plain reference.

The window is a closed loop with one client: `serve.py`'s render lock
serialises the device's work, so one user or one batch job renders photo
after photo. Each render takes the next photo of the pool and calls the
program's entry that the configuration names (`entry`, with the keyword
arguments under `render`) as `MosaicService.render_plan(..., encode=False)`
does (`serve.py`), with the tile stack on the host, as the service holds
it.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import json
import os
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench_torch import reference, spec
from bench_torch import trace as tr
from bench_torch.scene import make_scene, sizes

#: renders before the window (the pool's first photos): builds, loads and
#: warms every kernel and buffer the cell's shapes use
N_WARM = 2
#: renders at the window's start that the profiler traces (--trace 1): 16,
#: or as many as end within TRACE_S seconds, at least one (a long render's
#: trace holds tens of thousands of launches, and reading it takes time)
N_TRACE = 16
TRACE_S = 4.0
#: photos of the pool whose renders are checked, drawn from the seed before
#: the window: every render of them is compared item by item, and one
#: render of each byte by byte. Exact L1 over the full library costs the
#: reference seconds a photo, so a run checks a sample and not the whole
#: pool
CHECK_PHOTOS = 3
#: which occurrence of a checked photo has its image compared, among the
#: first IMAGE_DRAW, is drawn from the seed
IMAGE_DRAW = 3


def _quiet(*_a, **_k):
    pass


@dataclass
class Record:
    """One render of the window."""

    src: int
    latency_s: float
    pixels: int
    ok: bool
    info: dict | None


@dataclass
class Run:
    """What a metric's reader gets: the cell, its shapes, the window's
    records, the trace, the memory readings and the card's peaks."""

    cell: dict
    cfg: dict
    traffic: dict
    sizes: dict
    scene: object
    device: torch.device
    base: Path
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = field(default_factory=list)
    trace: tr.Trace | None = None
    traced_items: list = field(default_factory=list)
    traced_sources: list = field(default_factory=list)
    memory: dict = field(default_factory=dict)
    peaks: dict | None = None
    kind: str = ""
    _kernels: dict = field(default_factory=dict)
    _distinct: dict = field(default_factory=dict)

    def kernel(self, name: str):
        """`kernels/<name>.py`: its trace PATTERN and its `work(run)`."""
        if name not in self._kernels:
            self._kernels[name] = spec.load_module("kernels", name, self.base)
        return self._kernels[name]

    def distinct_blocks(self, i: int) -> int:
        """Distinct block vectors of pool photo i."""
        if i not in self._distinct:
            src = torch.from_numpy(self.scene.sources[i]).to(self.device)
            x = reference.blocks_of(src, self.sizes["dim"])
            self._distinct[i] = int(torch.unique(x, dim=0).shape[0])
        return self._distinct[i]


#: the package whose entries a configuration may name
PROGRAM = "emosaic_tpu_torch"


def entry(cfg: dict, tile_set, stack, device):
    """The program's render of one photo, as the service calls it: the
    configuration's `entry` ("module:function" of the program) with its
    `render` keyword arguments. Looked up when the run starts (a test may
    put a faulty one there)."""
    mod, _, name = cfg["entry"].partition(":")
    if mod.split(".")[0] != PROGRAM or not name:
        raise spec.SpecError(f"entry {cfg['entry']!r} is not a {PROGRAM} function")
    fn = getattr(importlib.import_module(mod), name)
    kw = dict(cfg.get("render", {}))
    ts = cfg["tile_size"]
    return lambda src: fn(src, tile_set, ts, device=device, stack=stack, compose=True,
                          log=_quiet, **kw)


#: what `nvidia-smi` reads after the window
CLOCKS = "clocks.sm,power.draw,temperature.gpu"


def card_line(query: str = "name,power.limit") -> str:
    """The card's name and power limit (or `query`), as `nvidia-smi` reads
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def host_line() -> str:
    """The host as the run sees it: the CPUs it may use and the one it is
    on, the NUMA nodes, transparent huge pages, and the rate of a 256 MB
    copy into fresh memory (the kind of copy each render's pageable
    transfers make)."""
    def read(path):
        try:
            return Path(path).read_text().strip()
        except OSError:
            return "?"

    cpu = read("/proc/self/stat").rsplit(")", 1)[-1].split()
    nodes = len(list(Path("/sys/devices/system/node").glob("node[0-9]*")))
    a = np.ones(1 << 28, np.uint8)
    t0 = time.perf_counter()
    b = a.copy()
    rate = a.nbytes / (time.perf_counter() - t0) / 1e9
    del a, b
    return (f"cpus {len(os.sched_getaffinity(0))}, on cpu {cpu[36] if len(cpu) > 36 else '?'}, "
            f"numa nodes {nodes}, thp {read('/sys/kernel/mm/transparent_hugepage/enabled')}, "
            f"fresh copy {rate:.2f} GB/s")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def compare(outputs: list, images: dict, refs: dict, failed: int) -> dict:
    """The numbers `correct` is decided on, each with its limit: renders
    that raised, items that differ from the reference's grid (every render
    of the window), bytes that differ from the reference's image (one
    render per photo)."""
    items_bad = sum(int(np.count_nonzero(items != refs[i][0])) for i, items in outputs)
    bytes_bad = 0
    for i, img in images.items():
        ref_img = refs[i][1]
        got = torch.from_numpy(np.ascontiguousarray(img)).to(ref_img.device)
        bytes_bad += (int((got != ref_img).sum()) if got.shape == ref_img.shape
                      else int(ref_img.numel()))
    return {
        "renders_failed": {"value": failed, "limit": 0},
        "item_mismatches": {"value": items_bad, "limit": 0},
        "image_byte_mismatches": {"value": bytes_bad, "limit": 0},
    }


def semantics(cfg: dict, base: Path = spec.HERE):
    """The reference's semantics the configuration names,
    `semantics/<name>.py`."""
    return spec.load_module("semantics", cfg["reference"], base)


def references(run: Run, which, bits: int = 8) -> dict:
    """{pool index: (items [nby, nbx] host int32, image on the device)}."""
    sc, out = run.scene, {}
    sem = semantics(run.cfg, run.base)
    for i in which:
        src = torch.from_numpy(sc.sources[i]).to(run.device)
        items, image = sem.render(src, sc.palettes, sc.stack, run.cfg, bits)
        out[i] = (items.cpu().numpy(), image)
        del src
    return out


def _metrics(bench, run: Run, cell_name: str, trace: bool) -> dict:
    out = {}
    for m in bench.metrics_of(cell_name, trace):
        value = spec.load_module("metrics", m["name"], run.base).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(bench, cell_name: str, *, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, base: Path = spec.HERE) -> dict:
    """Run `cell_name` once; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    from emosaic_tpu_torch.ops import _kernels
    from emosaic_tpu_torch.tiles.tileset import TileSet

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = bench.cell(cell_name)
    cfg = spec.config_of(bench, cell)
    traffic = spec.traffic_of(cell, base)
    if cuda:
        built = _kernels.build_all()
        print(f"kernels built or found: {built}", file=sys.stderr)
        print(f"card: {card_line()}", file=sys.stderr)
    print(f"host: {host_line()}", file=sys.stderr)
    sc = make_scene(cfg, traffic, seed, dev, base)
    run = Run(cell=cell, cfg=cfg, traffic=traffic, sizes=sizes(cfg), scene=sc,
              device=dev, base=base)
    tile_set = TileSet.from_arrays(sc.palettes.cpu().numpy(),
                                   [f"synthetic/{i:05d}.jpg" for i in range(cfg["tiles"])])
    render = entry(cfg, tile_set, sc.stack_host, device)
    pool = sc.sources
    for j in range(N_WARM):
        render(pool[j % len(pool)])
    _sync(dev)
    run.memory["setup_peak_bytes"] = _peak(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        run.kind = torch.cuda.get_device_name(dev)
        run.peaks = json.loads((base / "peaks.json").read_text()).get(run.kind)
    else:
        run.kind = "cpu"
    for k in _kernels.KERNELS:
        k.launches = 0
    run.setup_s = time.perf_counter() - t_start

    draw = random.Random(seed)
    checked = draw.sample(range(len(pool)), min(CHECK_PHOTOS, len(pool)))
    want = {i: draw.randrange(IMAGE_DRAW) for i in checked}
    outputs, images, failed = [], {}, 0
    tracing = contextlib.ExitStack()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = tracing.enter_context(torch.profiler.profile(activities=acts))
        tracing.enter_context(torch.profiler.record_function(tr.WINDOW))
    t_w0 = t1 = time.perf_counter()
    j = 0
    while True:
        i = j % len(pool)
        t0 = time.perf_counter()
        try:
            out = render(pool[i])
        except Exception:  # a failed render counts, and the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        ok = out is not None
        img = out.image if ok else None
        run.records.append(Record(i, t1 - t0, img.shape[0] * img.shape[1] if ok else 0,
                                  ok, out.info if ok else None))
        if ok and i in want:
            outputs.append((i, out.items))
            if j // len(pool) <= want[i]:
                images[i] = img
        if ok and prof is not None:
            run.traced_items.append(out.items)
            run.traced_sources.append(i)
        del out, img
        j += 1
        if prof is not None and (j == N_TRACE or t1 - t_w0 >= min(seconds, TRACE_S)):
            _sync(dev)
            tracing.close()
            run.trace = tr.reduce(prof, len(run.traced_items))
            prof = None
        # every photo of the pool at least once
        if t1 - t_w0 >= seconds and j >= len(pool):
            break
    run.window_s = t1 - t_w0
    _sync(dev)
    run.memory["window_peak_bytes"] = _peak(dev)
    launches = {k.name: k.launches for k in _kernels.KERNELS if k.launches}
    print(f"window: {len(run.records)} renders in {run.window_s:.3f} s, {failed} failed; "
          f"kernel launches {launches}", file=sys.stderr)
    routes = collections.Counter(
        (r.info.get("scoring", {}).get("route", r.info.get("scorer")),
         r.info.get("refill_events")) for r in run.records if r.info)
    if routes:
        print(f"renders by (scoring route, refill events): {dict(routes)}", file=sys.stderr)
    lat = [r.latency_s for r in run.records]
    quarters = [lat[q * len(lat) // 4 : (q + 1) * len(lat) // 4] for q in range(4)]
    print("latency s: min {:.4f} median {:.4f} max {:.4f}; mean by quarter {}".format(
        min(lat), sorted(lat)[len(lat) // 2], max(lat),
        [round(sum(q) / len(q), 4) for q in quarters if q]), file=sys.stderr)
    if cuda:
        print(f"card after the window: {card_line(CLOCKS)}", file=sys.stderr)
    print(f"host after the window: {host_line()}", file=sys.stderr)

    result = {
        "correct": False,
        "attempted": len(run.records),
        "failed": failed,
        "metrics": _metrics(bench, run, cell_name, trace),
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": run.kind,
            "count": 1,
            "memory_peak_bytes": max(run.memory["setup_peak_bytes"],
                                     run.memory["window_peak_bytes"]),
        },
    }
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}

    # the program's state goes before the reference runs
    del render, tile_set
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = references(run, sorted({i for i, _ in outputs}))
    checks = compare(outputs, images, refs, failed)
    print(f"reference: {len(refs)} photos in {time.perf_counter() - t0:.3f} s; "
          f"{len(outputs)} item grids and {len(images)} images compared", file=sys.stderr)
    result["correct"] = bool(outputs) and all(c["value"] <= c["limit"]
                                              for c in checks.values())
    result["checks"] = checks
    return result


def print_checks(result: dict, file=sys.stderr) -> None:
    """Each number compared beside its limit, one line each."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=file)
