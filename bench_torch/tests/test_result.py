"""The result line's keys, and the run's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from bench_torch import spec

from . import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_keys(bench, trace):
    res = tiny.run(bench, "generate_m32.photo", trace=trace)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == bench.metrics[name]["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    want = {m["name"] for m in bench.metrics_of("generate_m32.photo", trace)}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # the CPU has no device trace: only the program's own numbers
        assert set(line["metrics"]) == {"norepeat.scoring_s", "norepeat.assign_s",
                                        "norepeat.refill_events"}
    else:
        assert set(line["metrics"]) == want


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", "cli_m4.photo",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""



def test_the_trace_counts_every_traced_render(bench, monkeypatch):
    """Per-render device times divide by every render the trace holds, not
    only the checked ones."""
    from bench_torch import harness, trace

    seen, real = [], trace.reduce
    monkeypatch.setattr(trace, "reduce", lambda prof, n: seen.append(n) or real(prof, n))
    monkeypatch.setattr(harness, "N_TRACE", 3)
    res = tiny.run(bench, "cli_m4.photo", seconds=3.0, trace=True)
    assert res["attempted"] > 3
    assert seen == [3]
