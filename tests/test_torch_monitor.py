"""`emosaic_tpu_torch.monitor`'s spans: what they add to a render's record,
the ranges they put on a running profiler's clock, and what they leave
alone (the device, the CLI's phase lines)."""

import pytest
import torch

from emosaic_tpu_torch import monitor


@pytest.fixture
def clock(monkeypatch):
    """`time.perf_counter` as a hand-moved clock: `clock[0]` is now."""
    now = [0.0]
    monkeypatch.setattr(monitor.time, "perf_counter", lambda: now[0])
    return now


def test_nested_spans_sum_wall_self_and_count(clock):
    info = {}
    with monitor.record(info) as rec:
        assert rec is info
        clock[0] = 1.0
        for _ in range(2):
            with monitor.span("a"):
                clock[0] += 1.0
                with monitor.span("b"):
                    clock[0] += 2.0
        clock[0] += 1.0
    assert info["spans"] == {
        "b": {"s": 4.0, "self_s": 4.0, "n": 2},
        "a": {"s": 6.0, "self_s": 2.0, "n": 2},
        "render": {"s": 8.0, "self_s": 2.0, "n": 1},
    }


def test_a_span_outside_a_record_adds_nothing(clock):
    with monitor.span("alone") as sp:
        clock[0] = 2.5
    assert sp.s == 2.5
    outer, inner = {}, {}
    with monitor.record(outer):
        with monitor.record(inner):  # a render inside another keeps its own record
            with monitor.span("x"):
                clock[0] += 1.0
        with monitor.span("y"):
            clock[0] += 1.0
    assert set(inner["spans"]) == {"x", "render"}
    assert set(outer["spans"]) == {"y", "render"}
    # the inner render is the outer one's child, as "y" is
    assert outer["spans"]["render"] == {"s": 2.0, "self_s": 0.0, "n": 1}
    with monitor.span("after"):
        pass
    assert "after" not in outer["spans"]


def test_spans_are_ranges_on_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with monitor.record({}):
            with monitor.span("outer"):
                with monitor.span("inner"):
                    torch.ones(4).sum()
    ev = {e.name(): (e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events() if e.name().startswith("emosaic:")}
    assert set(ev) == {"emosaic:render", "emosaic:outer", "emosaic:inner"}
    for parent, child in (("render", "outer"), ("outer", "inner")):
        p, c = ev[f"emosaic:{parent}"], ev[f"emosaic:{child}"]
        assert p[0] <= c[0] <= c[1] <= p[1]


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    info = {}
    with monitor.record(info):
        with monitor.span("x"):
            pass
    assert set(info["spans"]) == {"x", "render"}


@pytest.mark.parametrize("profiled", [False, True])
def test_a_span_never_synchronises_the_device(monkeypatch, profiled):
    def refuse(*a, **k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) if profiled else monitor.span("outside"):
        with monitor.record({}):
            with monitor.span("x"):
                torch.ones(2).sum()


def test_phase_timer_lines_are_unchanged(clock):
    lines = []
    timer = monitor.PhaseTimer(lines.append)
    with timer.phase("tile analysis (cache/generate)"):
        clock[0] += 1.234
    with timer.phase("match + compose"):
        clock[0] += 0.5
    timer.report()
    assert lines == [
        "⏱  Phase timings:",
        "   tile analysis (cache/generate): 1.23s",
        "   match + compose: 0.50s",
    ]


def test_phases_are_ranges_in_a_profile():
    timer = monitor.PhaseTimer(lambda *a: None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.phase("match + compose"):
            torch.ones(2).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "emosaic:match + compose" in names
