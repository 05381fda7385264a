"""The cell `cli_m32_lib100k.photo` at a tiny size (the repository root's
`conftest.py`): the repeat render against `semantics/l1_nearest.py`, its
per-layer metrics, K1's staged path's count, and the control."""

import pytest

from bench_torch import control, harness, roofline, spec
from bench_torch.scene import sizes
from bench_torch.trace import Trace

from . import tiny

CELL = "cli_m32_lib100k.photo"
NEW = ("k1_staged_roofline", "prologue.library_s", "compose.stack_s", "match.scored_pct")
PEAKS = {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1.979e15, "fp32_flops_per_s": 6.7e13}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def test_the_cell_lists_the_new_metrics_alone():
    b = spec.load_benchmark()
    assert [m["name"] for m in b.metrics_of(CELL, True)] == list(NEW)
    for name in NEW:
        assert b.metrics[name]["workloads"] == [CELL]
        assert b.metrics[name]["moves"] == "mpix_per_s"
    assert [m["name"] for m in b.metrics_of(CELL, False)] == ["mpix_per_s", "setup_s"]


def test_sound_runs_are_correct(bench):
    res = tiny.run(bench, CELL)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"mpix_per_s", "setup_s"}


def test_the_traced_run_reads_the_new_metrics(bench):
    """On the CPU the trace has no device and the run no peaks, so K1's
    staged share is left out; the spans and the match's record are read."""
    res = tiny.run(bench, CELL, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert set(m) == set(NEW) - {"k1_staged_roofline"}
    assert m["match.scored_pct"]["value"] == 100.0
    assert m["prologue.library_s"]["value"] > 0 and m["compose.stack_s"]["value"] > 0


def _run(records=(), trace=None):
    cfg = spec.load_json(spec.ROOT / "bench_torch" / "configs" / "cli_m32_lib100k.json")
    run = harness.Run(cell={}, cfg=cfg, traffic={}, sizes=sizes(cfg), scene=None,
                      device="cpu", base=spec.HERE)
    run.records = list(records)
    run.trace, run.peaks = trace, PEAKS
    run.traced_sources = [0, 1]
    run._distinct = {0: 16384, 1: 16000}
    return run


def test_the_readers_give_nothing_without_what_they_read():
    """A window whose renders hold neither the new spans nor a match record
    (a program without them, or another route) reads nothing, and raises
    nothing; nor does a trace without K1's staged kernel."""
    old = {"spans": {"render.prologue": {"s": 1.0, "self_s": 1.0, "n": 1}}}
    run = _run([harness.Record(0, 1.0, 1, True, old), harness.Record(0, 1.0, 1, True, None)],
               Trace(device=[("void l1_argmin_reg<12>(args)", 0.0, 10.0)], end=20.0, renders=1))
    for name in NEW:
        assert spec.load_module("metrics", name).read(run) is None


def test_scored_pct_is_the_mean_over_renders():
    recs = [harness.Record(0, 1.0, 1, True, {"match": {"blocks": 100, "scored": s}})
            for s in (100, 50)]
    run = _run(recs + [harness.Record(0, 1.0, 1, True, {"match": {}})])
    assert spec.load_module("metrics", "match.scored_pct").read(run) == 75.0


def test_k1_staged_counts_k1s_work_and_reads_the_staged_kernels():
    run = _run(trace=Trace(device=[
        ("void (anonymous namespace)::init_keys(unsigned long long*, long long)", 0.0, 10.0),
        ("void (anonymous namespace)::l1_argmin_staged(args)", 10.0, 150010.0),
        ("void (anonymous namespace)::unpack_keys(args)", 150010.0, 150020.0),
        ("void (anonymous namespace)::l1_argmin_reg<12>(args)", 0.0, 99.0),
        ("compose_kernel", 150020.0, 151000.0)], end=200000.0, renders=1))
    k1, staged = run.kernel("k1"), run.kernel("k1_staged")
    assert staged.work(run) == k1.work(run)
    ops, nbytes, peak = staged.work(run)
    rows = (16384 + 16000) / 2
    assert ops == 2 * rows * 200000 * 3072 and peak == "int8_ops_per_s"
    assert nbytes == rows * 3072 + 200000 * 3072 + rows * 8
    assert run.trace.per_render(staged.PATTERN) == pytest.approx(0.15002)
    share = roofline.share(run, "k1_staged")
    assert share == pytest.approx(100 * ops / 1.979e15 / 0.15002)
    # the VABSDIFF4 rate (132 SMs x 64 lanes x 4 byte pairs x 1980 MHz) as a
    # share of the int8 peak: the staged path's reachable ceiling
    assert 100 * 2 * 132 * 64 * 4 * 1.98e9 / 1.979e15 == pytest.approx(6.76, abs=0.005)


def test_the_control_fails_on_three_seeds(bench):
    for seed, res in control.run(bench, CELL, [11, 12, 2**31 + 3], 0.2, "cpu",
                                 base=bench.root / "bench_torch"):
        assert not res["correct"], (seed, res["checks"])
        assert res["checks"]["item_mismatches"]["value"] > 0


def test_the_configuration_at_its_size():
    """16384 blocks against 200000 rows of 3072 bytes, past the reference's
    32767-tile cap: K1's staged path, one launch of 128 query tiles over 9
    library splits on the H100's 132 SMs."""
    from emosaic_tpu_torch.ops import distance

    bench = spec.load_benchmark()
    cfg = spec.config_of(bench, bench.cell(CELL))
    assert cfg["entry"] == "emosaic_tpu_torch.render.matched:render_nto1"
    assert cfg["render"] == {} and cfg["reference"] == "l1_nearest" and cfg["reduced"] == []
    sz = sizes(cfg)
    assert (sz["B"], sz["T"], sz["L"], sz["D"], sz["out_pixels"]) == (
        16384, 100000, 200000, 3072, 4096 * 4096)
    assert sz["T"] > 32767
    assert distance._k1_plan(sz["B"], sz["L"], sz["D"], 132) == (768, 128, 9, 174)
    assert bench.configs["cli_m32_lib100k"]["source"] == cfg["source"]
