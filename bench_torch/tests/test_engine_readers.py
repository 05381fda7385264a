"""The readers of the no-repeat engine's inside readings, on hand-made runs:
the idle time the spans leave unexplained and the engine's share of it
(from the traced renders' `info["timeline"]`), and the engine's counters
(`emosaic_tpu_torch.native.STATS`, `refill_wait_s`)."""

import pytest

from bench_torch import harness, spec
from bench_torch.scene import sizes
from bench_torch.trace import Trace

#: a window of 100 us: three device operations, idle in [0, 10], [20, 40],
#: [50, 80] and [90, 100]
DEVICE = [("k1", 10.0, 20.0), ("Memcpy DtoH (Device -> Pageable)", 40.0, 50.0),
          ("k2", 80.0, 90.0)]
#: two renders' timelines: the engine from 20 to 85 us with a refill call
#: inside it over part of the second gap, then the stats
TIMELINES = [
    [["render", 5.0, 48.0], ["render.prologue", 5.0, 15.0],
     ["norepeat.engine", 20.0, 47.0], ["norepeat.refill", 25.0, 30.0]],
    [["render", 49.0, 95.0], ["norepeat.engine", 49.0, 85.0],
     ["render.stats", 86.0, 94.0]],
]
COUNTERS = ("norepeat.gather_s", "norepeat.trampoline_s", "norepeat.refill_wait_s")
IDLE = ("device.idle_unattributed_pct", "norepeat.engine_idle_pct")
NEW = IDLE + COUNTERS + ("norepeat.loop_s", "norepeat.requeues_per_block")


def _run(infos, trace=None):
    cfg = {"mode": 16, "tile_size": 32, "tiles": 4096, "source_height": 1024,
           "source_width": 1024}
    run = harness.Run(cell={}, cfg=cfg, traffic={}, sizes=sizes(cfg), scene=None,
                      device="cpu", base=spec.HERE)
    run.records = [harness.Record(0, 1.0, 1, True, i) for i in infos]
    run.trace = trace
    return run


def _trace(device=DEVICE):
    return Trace(device=list(device), start=0.0, end=100.0, renders=2)


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def _engine(cb_events, cb_s=0.0, gather_s=0.0, wait_s=0.0, refill_s=None, **more):
    info = {"engine_cb_events": cb_events, "engine_cb_s": cb_s, "engine_gather_s": gather_s,
            "refill_wait_s": wait_s, "engine_loop_s": 0.0, "engine_requeues": 0, **more}
    if refill_s is not None:
        info["spans"] = {"norepeat.refill": {"s": refill_s, "self_s": refill_s, "n": cb_events}}
    return info


def test_the_benchmark_lists_the_readers_in_their_cells():
    b = spec.load_benchmark()
    cells = {name: b.metrics[name]["workloads"] for name in NEW}
    assert cells["device.idle_unattributed_pct"] == [
        "generate_m32.photo", "cli_m4.photo", "service_m16.exact_full", "greedy_m32.photo"]
    assert cells["norepeat.engine_idle_pct"] == ["generate_m32.photo", "service_m16.exact_full"]
    for name in COUNTERS:
        assert cells[name] == ["generate_m32.photo"]
    for name in ("norepeat.loop_s", "norepeat.requeues_per_block"):
        assert cells[name] == ["service_m16.exact_full"]
    for name in NEW:
        assert b.metrics[name]["moves"] == "mpix_per_s"
        assert b.metrics[name]["source"] == ("device_trace" if name in IDLE else "program_counter")
    # the new entries come last, in this order
    assert [m["name"] for m in b.raw["per_layer"][-len(NEW):]] == list(NEW)


def test_the_idle_readers_split_the_window_by_the_timeline():
    run = _run([{"timeline": TIMELINES[0]}, {"timeline": TIMELINES[1]}, None], _trace())
    # idle with no span below the root: [0, 5] and [95, 100] (no span) and
    # [94, 95] (the root alone); the engine's own idle time: [20, 25],
    # [30, 40] and [50, 80], not the refill's [25, 30]
    assert _read("device.idle_unattributed_pct", run) == pytest.approx(5 + 5 + 1)
    assert _read("norepeat.engine_idle_pct", run) == pytest.approx(5 + 10 + 30)


def test_the_idle_readers_give_nothing_without_a_trace_or_a_timeline():
    with_tl = [{"timeline": TIMELINES[0]}]
    for run in (_run(with_tl), _run(with_tl, _trace(device=[])),
                _run([{"spans": {}}, None], _trace()), _run([], _trace())):
        for name in IDLE:
            assert _read(name, run) is None, name
    # a timeline without the engine's span: the engine's share is not there
    other = _run([{"timeline": [["render", 0.0, 100.0], ["render.match", 1.0, 99.0]]}],
                 _trace())
    assert _read("norepeat.engine_idle_pct", other) is None
    assert _read("device.idle_unattributed_pct", other) == pytest.approx(2.0)


def test_the_counter_readers_are_means_over_the_engines_renders():
    run = _run([_engine(10, cb_s=0.5, gather_s=0.1, wait_s=0.2, refill_s=0.3),
                _engine(30, cb_s=0.9, gather_s=0.3, wait_s=0.4, refill_s=0.6),
                None, {"spans": {}}])
    assert _read("norepeat.gather_s", run) == pytest.approx(0.2)
    assert _read("norepeat.trampoline_s", run) == pytest.approx((0.2 + 0.3) / 2)
    assert _read("norepeat.refill_wait_s", run) == pytest.approx(0.3)


def test_the_callback_readers_give_nothing_without_callback_events():
    """No record with the counters (a program without them), or none whose
    engine made a callback (the exact-full route, or the CPU's sizes):
    nothing, whatever else the records hold."""
    refill = {"norepeat.refill": {"s": 0.3, "self_s": 0.3, "n": 4}}
    for infos in ([], [None], [{"spans": refill, "refill_events": 4}],
                  [_engine(0, refill_s=0.0), _engine(0)]):
        for name in COUNTERS:
            assert _read(name, _run(infos)) is None, (name, infos)


def test_the_trampoline_never_reads_a_refill_span_without_callback_counters():
    """A render whose record has the `norepeat.refill` span but not the
    engine's callback counters takes no part: its span is not subtracted
    from another render's callback seconds, nor counted as a render."""
    stray = {"spans": {"norepeat.refill": {"s": 9.0, "self_s": 9.0, "n": 1}},
             "refill_wait_s": 5.0}
    run = _run([_engine(10, cb_s=0.5, wait_s=0.1, refill_s=0.3), stray])
    assert _read("norepeat.trampoline_s", run) == pytest.approx(0.2)
    assert _read("norepeat.refill_wait_s", run) == pytest.approx(0.1)
    # a render with counters but without the span: all of its callback seconds
    run = _run([_engine(10, cb_s=0.5)])
    assert _read("norepeat.trampoline_s", run) == pytest.approx(0.5)


def test_the_loop_and_requeue_readers():
    b = 4096
    run = _run([{"engine_loop_s": 0.010, "engine_requeues": 2 * b},
                {"engine_loop_s": 0.014, "engine_requeues": 4 * b}, None])
    assert _read("norepeat.loop_s", run) == pytest.approx(0.012)
    assert _read("norepeat.requeues_per_block", run) == pytest.approx(3.0)
    for infos in ([], [None], [{"engine_entries": 10, "spans": {}}]):
        for name in ("norepeat.loop_s", "norepeat.requeues_per_block"):
            assert _read(name, _run(infos)) is None
