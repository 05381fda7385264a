"""The device's idle time put down to the program's spans (`spans.py`),
on hand-made traces, and the spans read from a CPU profile and from the
renders' records."""

from types import SimpleNamespace

import pytest

from bench_torch import spans
from bench_torch.trace import Trace

#: a window of 100 us: three device operations, idle in [0, 10], [20, 40],
#: [50, 80] and [90, 100]
DEVICE = [("k1", 10.0, 20.0), ("Memcpy DtoH (Device -> Pageable)", 40.0, 50.0),
          ("k2", 80.0, 90.0)]
#: the root, a prologue over the first gap's end, a match with a refill
#: inside it over the second gap, stats inside the third
HOST = [("render", 5.0, 95.0), ("render.prologue", 5.0, 15.0),
        ("render.match", 18.0, 45.0), ("norepeat.refill", 25.0, 30.0),
        ("render.stats", 55.0, 70.0)]


def _trace():
    return Trace(device=list(DEVICE), start=0.0, end=100.0, renders=1)


def test_idle_split_by_the_innermost_span():
    tr = _trace()
    got = dict(spans.idle_by_span(tr, HOST))
    want = {"no span": 10.0, "render.prologue": 5.0, "render.match": 15.0,
            "norepeat.refill": 5.0, "render": 20.0, "render.stats": 15.0}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e6)
    order = [v for _, v in spans.idle_by_span(tr, HOST)]
    assert order == sorted(order, reverse=True)
    # idle with no span or only the root open: 30 of the 100 us
    assert spans.unattributed_pct(tr, HOST) == pytest.approx(30.0)
    # every idle microsecond is put down once
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_idle_gaps_are_unchanged():
    tr = _trace()
    want = [["after Memcpy DtoH, before k2", 30e-6], ["after k1, before Memcpy DtoH", 20e-6],
            ["after window start, before k1", 10e-6], ["after k2, before window end", 10e-6]]
    before = tr.idle_gaps()
    spans.idle_by_span(tr, HOST)
    assert tr.idle_gaps() == before
    assert [k for k, _ in before] == [k for k, _ in want]
    assert [v for _, v in before] == pytest.approx([v for _, v in want])


def test_spans_open_before_the_window_and_no_spans():
    tr = _trace()
    # a span that opened before the window covers its start
    got = dict(spans.idle_by_span(tr, [("render", -50.0, 200.0)]))
    assert got == {"render": pytest.approx(70e-6)}
    assert spans.unattributed_pct(tr, []) == pytest.approx(70.0)
    assert spans.unattributed_pct(Trace(start=0.0, end=100.0), HOST) is None


def test_host_spans_from_a_cpu_profile():
    import torch

    from emosaic_tpu_torch import monitor

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with monitor.record({}):
            with monitor.span("render.match"):
                torch.ones(8).sum()
    host = spans.host_spans(prof)
    assert sorted(n for n, _, _ in host) == ["render", "render.match"]
    (_, r0, r1), = [h for h in host if h[0] == "render"]
    (_, m0, m1), = [h for h in host if h[0] == "render.match"]
    assert r0 <= m0 <= m1 <= r1


def test_per_render_counts_renders_without_the_span_as_zero():
    rec = lambda sp: SimpleNamespace(info={"spans": sp})  # noqa: E731
    run = SimpleNamespace(records=[
        rec({"render.match": {"s": 2.0, "self_s": 1.0, "n": 1}}),
        rec({"render": {"s": 9.0, "self_s": 9.0, "n": 1}}),
        SimpleNamespace(info=None)])
    assert spans.per_render(run, "render.match") == 1.0
    assert spans.per_render(run, "render.match", "self_s") == 0.5
    assert spans.per_render(run, "norepeat.refill") is None
