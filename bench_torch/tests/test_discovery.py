"""A configuration (with its own entry arguments, photo shape and
reference semantics), a traffic kind and mix, a cell, a metric and a
kernel count are added as new files and entries only: no file of the
harness changes."""

import json

from . import tiny

#: a reference for `--metric l2`: each block's nearest row by squared L2,
#: the lowest among equal distances
L2_NEAREST = '''
from bench_torch import reference


def _nearest(x, lib, bits=8):
    x, lib = (x >> (8 - bits)).long(), (lib >> (8 - bits)).long()
    d = ((x[:, None, :] - lib[None]) ** 2).sum(-1)
    cols = reference.torch.arange(lib.shape[0])
    return ((d * lib.shape[0] + cols).amin(1) % lib.shape[0])


def render(src, pal, stack, cfg, bits=8):
    return reference.render(src, pal, stack, cfg["mode"], _nearest, bits)
'''

#: a source kind: diagonal colour ramps, their slopes drawn from the seed
RAMPS = '''
import torch


def pool(params, ctx, n):
    h, w = ctx.sizes["height"], ctx.sizes["width"]
    y = torch.arange(h, device=ctx.dev)[:, None, None]
    x = torch.arange(w, device=ctx.dev)[None, :, None]
    out = []
    for _ in range(n):
        a = torch.randint(1, params["steepest"], (2, 3), generator=ctx.gen, device=ctx.dev)
        out.append(((a[0] * y + a[1] * x) % 256).to(torch.uint8))
    return out
'''


def test_new_files_only(tmp_path):
    bench = tiny.make(tmp_path)
    root, base = bench.root, bench.root / "bench_torch"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "configs" / "cli_m8_l2.json").write_text(json.dumps({
        "name": "cli_m8_l2", "source": "https://example.org/m8",
        "entry": "emosaic_tpu_torch.render.matched:render_nto1", "render": {"metric": "l2"},
        "reference": "l2_nearest", "mode": 8, "tile_size": 8, "tiles": 200,
        "source_height": 48, "source_width": 96, "reduced": []}))
    (base / "semantics" / "l2_nearest.py").write_text(L2_NEAREST)
    (base / "traffic" / "ramps.py").write_text(RAMPS)
    (base / "traffic" / "ramps_on_clustered.json").write_text(json.dumps({
        "pool": 3, "library": {"kind": "lib_clustered", "texture": 4},
        "sources": {"kind": "ramps", "steepest": 9}}))
    (base / "kernels" / "k3.py").write_text(
        'PATTERN = r"\\bl1_rows_kernel\\b"\n\n\ndef work(run):\n    return 1, 1, "int8_ops_per_s"\n')
    (base / "metrics" / "window.renders.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    (base / "metrics" / "k3_roofline.py").write_text(
        "from bench_torch.roofline import share\n\n\ndef read(run):\n    return share(run, 'k3')\n")
    (base / "metrics" / "window.max_s.py").write_text(
        "def read(run):\n    return max(r.latency_s for r in run.records)\n")
    raw = json.loads((root / "BENCHMARK.json").read_text())
    raw["configs"].append({"name": "cli_m8_l2", "source": "https://example.org/m8",
                           "file": "bench_torch/configs/cli_m8_l2.json", "reduced": [],
                           "why": "a test"})
    raw["workloads"].append({"name": "cli_m8_l2.ramps", "config": "cli_m8_l2",
                             "traffic": "ramps_on_clustered", "chips": 1, "why": "a test"})
    raw["end_to_end"].append({"name": "window.max_s", "unit": "s", "better": "lower",
                              "bound": 0.2, "source": "host_clock",
                              "workloads": ["cli_m8_l2.ramps"]})
    raw["per_layer"] += [
        {"name": "window.renders", "unit": "renders", "better": "higher",
         "source": "program_counter", "layer": "harness", "moves": "mpix_per_s",
         "workloads": ["cli_m8_l2.ramps"]},
        {"name": "k3_roofline", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "kernel K3", "moves": "mpix_per_s", "workloads": ["cli_m8_l2.ramps"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(raw))
    bench = tiny.spec.load_benchmark(root / "BENCHMARK.json")

    res = tiny.run(bench, "cli_m8_l2.ramps")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"mpix_per_s", "setup_s", "window.max_s"}
    traced = tiny.run(bench, "cli_m8_l2.ramps", trace=True)
    assert traced["correct"]
    # K3 does not run on this path: its share is left out, never 0
    assert set(traced["metrics"]) == {"window.renders"}
    assert traced["metrics"]["window.renders"]["value"] == traced["attempted"]
    assert any(p.read_bytes() != b for p, b in before.items()) is False
    # the cells that were there run as before
    assert tiny.run(bench, "cli_m4.photo")["correct"]


def test_the_new_semantics_is_what_is_compared(tmp_path):
    """The L1 reference in the L2 cell's place comes out as not correct:
    the configuration's own semantics decides."""
    bench = tiny.make(tmp_path)
    root, base = bench.root, bench.root / "bench_torch"
    cfg = json.loads((base / "configs" / "cli_m4.json").read_text())
    cfg.update(render={"metric": "l2"})
    (base / "configs" / "cli_m4.json").write_text(json.dumps(cfg))
    bench = tiny.spec.load_benchmark(root / "BENCHMARK.json")
    assert not tiny.run(bench, "cli_m4.photo")["correct"]
    (base / "semantics" / "l2_nearest.py").write_text(L2_NEAREST)
    (base / "configs" / "cli_m4.json").write_text(json.dumps(dict(cfg, reference="l2_nearest")))
    bench = tiny.spec.load_benchmark(root / "BENCHMARK.json")
    assert tiny.run(bench, "cli_m4.photo")["correct"]
