"""BENCHMARK.json and its files keep the contract's rules of form, and
every name it gives has its file."""

import json

import pytest

from bench_torch import harness, spec


def test_the_benchmark_loads_and_every_name_has_its_file():
    b = spec.load_benchmark()
    assert b.raw["command"] == ["python3", "bench_torch/run.py"]
    assert b.raw["paths"] == ["bench_torch"]
    for c in b.raw["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("bench_torch/configs/")
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
    for w in b.raw["workloads"]:
        assert w["chips"] == 1
        assert spec.traffic_of(w)["pool"] >= 1
    for name in b.metrics:
        assert hasattr(spec.load_module("metrics", name), "read")
    for cell in b.workloads:
        for trace in (False, True):
            assert b.metrics_of(cell, trace), (cell, trace)
        assert "setup_s" in [m["name"] for m in b.metrics_of(cell, False)]
    assert len(json.dumps(b.raw)) < 64 * 1024


def test_every_entry_semantics_and_traffic_kind_exists():
    import importlib

    b = spec.load_benchmark()
    for w in b.raw["workloads"]:
        cfg = spec.config_of(b, w)
        mod, _, name = cfg["entry"].partition(":")
        assert mod.startswith(harness.PROGRAM + ".")
        assert callable(getattr(importlib.import_module(mod), name))
        assert isinstance(cfg["render"], dict)
        assert callable(harness.semantics(cfg).render)
        mix = spec.traffic_of(w)
        assert callable(spec.load_module("traffic", mix["library"]["kind"]).library)
        assert callable(spec.load_module("traffic", mix["sources"]["kind"]).pool)


def test_an_entry_outside_the_program_is_refused():
    with pytest.raises(spec.SpecError):
        harness.entry({"entry": "os:system", "tile_size": 8}, None, None, "cpu")


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "-x", "µs", "x" * 65, 7])
def test_names_are_checked(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "metric")


@pytest.mark.parametrize("good", ["mpix_per_s", "k9_roofline", "cli_m4.photo", "_x", "9a-b"])
def test_good_names_pass(good):
    assert spec.check_name(good, "metric") == good


@pytest.mark.parametrize("unit,ok", [("Mpx/s", True), ("%", True), ("tokens/s", True),
                                     ("GB", True), ("tokens per s", False), ("µs", False),
                                     ("x" * 17, False), ("", False)])
def test_units_are_checked(unit, ok):
    if ok:
        assert spec.check_unit(unit, "m") == unit
    else:
        with pytest.raises(spec.SpecError):
            spec.check_unit(unit, "m")


def test_a_bad_benchmark_is_refused(tmp_path):
    raw = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for breakage in (lambda r: r["workloads"][0].update(why="two\nlines"),
                     lambda r: r["per_layer"][0].update(moves="no_such_metric"),
                     lambda r: r["end_to_end"][0].update(extra=1),
                     lambda r: r["workloads"].append(dict(r["workloads"][0])),
                     lambda r: r["per_layer"][0].update(workloads=["no_such_cell"]),
                     lambda r: r.update(run_seconds=52)):
        broken = json.loads(json.dumps(raw))
        breakage(broken)
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(broken))
        with pytest.raises(spec.SpecError):
            spec.load_benchmark(tmp_path / "BENCHMARK.json")
