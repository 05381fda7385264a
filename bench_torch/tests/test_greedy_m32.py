"""The cell `greedy_m32.photo` at a tiny size (`bench_torch/conftest.py`):
the in-render no-repeat render against `semantics/l1_sequence.py`, its
per-layer metrics, and the control."""

import pytest

from bench_torch import control

from . import tiny

CELL = "greedy_m32.photo"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def test_sound_runs_are_correct(bench):
    res = tiny.run(bench, CELL)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_the_traced_run_reads_the_new_metrics(bench):
    """On the CPU the trace has no device, so the program's own numbers are
    the per-layer metrics the cell reports."""
    res = tiny.run(bench, CELL, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert set(m) == {"sequence.scoring_s", "sequence.to_host_s", "sequence.engine_s",
                      "sequence.refill_host_events", "sequence.refill_host_s"}
    for name in ("sequence.scoring_s", "sequence.to_host_s", "sequence.engine_s"):
        assert m[name]["value"] > 0, name
    assert m["sequence.refill_host_events"]["value"] >= 0


def test_the_readers_give_nothing_without_the_sequence_spans(bench):
    """A window whose renders hold no `sequence.*` span (a program without
    them, or another route) reads nothing, and raises nothing."""
    from bench_torch import harness, spec
    from bench_torch.scene import sizes

    cfg = spec.config_of(bench, bench.cell(CELL))
    run = harness.Run(cell={}, cfg=cfg, traffic={}, sizes=sizes(cfg), scene=None,
                      device="cpu", base=bench.root / "bench_torch")
    run.records = [harness.Record(0, 1.0, 1, True, {"spans": {"render.match": {
        "s": 1.0, "self_s": 1.0, "n": 1}}, "refill_host_events": 3, "refill_host_s": 0.1}),
        harness.Record(0, 1.0, 1, True, None)]
    for name in ("sequence.scoring_s", "sequence.to_host_s", "sequence.engine_s",
                 "sequence.refill_host_events", "sequence.refill_host_s"):
        assert spec.load_module("metrics", name, run.base).read(run) is None


def test_the_global_greedy_in_its_place_fails(tmp_path):
    """The configuration's own semantics decides: the global greedy
    (`l1_greedy`) as this cell's reference comes out as not correct."""
    import json

    bench = tiny.make(tmp_path)
    path = bench.root / "bench_torch" / "configs" / "greedy_m32.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, reference="l1_greedy")))
    bench = tiny.spec.load_benchmark(bench.root / "BENCHMARK.json")
    res = tiny.run(bench, CELL)
    assert not res["correct"]
    assert res["checks"]["item_mismatches"]["value"] > 0


def test_the_control_fails_on_three_seeds(bench):
    for seed, res in control.run(bench, CELL, [11, 12, 2**31 + 3], 0.2, "cpu",
                                 base=bench.root / "bench_torch"):
        assert not res["correct"], (seed, res["checks"])
        assert res["checks"]["item_mismatches"]["value"] > 0


def test_the_configuration_at_its_size():
    """4096 blocks against 65534 rows of 3072 bytes: past `l1_topk`'s dense
    budget, so the lists come from the adaptive scorer, as in
    `generate_m32.photo`; the in-render render with the service's seed."""
    from bench_torch import spec
    from bench_torch.scene import sizes
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.render import matched

    bench = spec.load_benchmark()
    cfg = spec.config_of(bench, bench.cell(CELL))
    assert cfg["entry"] == "emosaic_tpu_torch.render.matched:render_nto1"
    assert cfg["render"] == {"no_repeat": True, "seed": 0}
    assert cfg["reference"] == "l1_sequence"
    sz = sizes(cfg)
    assert (sz["B"], sz["L"], sz["D"], sz["out_pixels"]) == (4096, 65534, 3072, 2048 * 2048)
    assert sz["B"] * sz["L"] > distance._TOPK_MATRIX_BUDGET
    assert matched._GREEDY_TOPK == 64
