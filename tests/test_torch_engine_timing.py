"""The no-repeat engine timed from inside, on the CPU: the native engine's
counters (`native.STATS`: its refill callbacks and their seconds, its
gathers, its stale requeues, its own loop), the device refill's
wait on the device (`DeviceRefiller.wait_s`), and the spans' entries on
the trace's clock (`monitor.span`, `info["timeline"]`) against their
profiler ranges.
"""

import itertools
import time

import numpy as np
import pytest
import torch

from bench_torch import spans as bench_spans
from emosaic_tpu_torch import monitor, native
from emosaic_tpu_torch.ops import refill
from emosaic_tpu_torch.ops.distance import I32_MAX
from emosaic_tpu_torch.ops.refill import DeviceRefiller
from emosaic_tpu_torch.render import norepeat
from emosaic_tpu_torch.render.greedy import make_numpy_refill
from emosaic_tpu_torch.tiles.tileset import TileSet

#: the seconds among the engine's counters
SECONDS = ("refill_host_s", "engine_cb_s", "engine_gather_s", "engine_loop_s")
#: what an engine without a heap or a refill callback leaves at 0
NO_HEAP = ("engine_cb_events", "engine_cb_s", "engine_gather_s", "engine_requeues")


@pytest.fixture
def engine():
    if not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    return native


def _clustered(seed, t=120, b=110, d=48, k=4):
    """Blocks near a clustered library of t tiles (2t rows with the
    mirrors), b <= t, and each block's k nearest (distance, row): short
    lists that run dry under contention."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 256, size=(5, d))
    pal = np.clip(centers[rng.integers(0, 5, t)] + rng.normal(0, 6, (t, d)), 0, 255)
    pal = pal.astype(np.uint8)
    lib = np.concatenate([pal, pal[:, ::-1]])
    blocks = np.clip(pal[rng.integers(0, t, b)] + rng.normal(0, 4, (b, d)), 0, 255)
    blocks = blocks.astype(np.uint8)
    dist = np.abs(blocks.astype(np.int32)[:, None] - lib.astype(np.int32)[None]).sum(2)
    order = np.argsort(dist, axis=1, kind="stable")
    cr = order[:, :k].astype(np.int32)
    return blocks, lib, np.take_along_axis(dist, cr, axis=1).astype(np.int32), cr, dist, order


def _counting(fn, calls):
    def cb(ids, used):
        calls.append(len(ids))
        return fn(ids, used)

    cb.k = getattr(fn, "k", 256)
    return cb


def _dry(k):
    """A callback that finds no unused row for any block."""
    def cb(ids, used):
        return np.full((len(ids), k), I32_MAX, np.int32), np.zeros((len(ids), k), np.int32)

    cb.k = k
    return cb


@pytest.mark.parametrize("route", ["callback", "device", "dry", "host", "keys"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_engine_counters_close(engine, seed, route):
    """A block is requeued only after one of its entries was skipped as
    used, so the requeues are at most the entries read less the assigned
    blocks, and every block is assigned or left without a candidate; the
    callback's events are its calls; every seconds slot is
    at least 0 and the engine's own loop fits in the call's wall with the
    rest; the output, and the counts of the first three slots, are the
    same with or without `stats`. Routes: a Python callback (the numpy
    refill), the device refiller on CPU tensors, a callback that finds
    nothing (blocks left without a tile), the engine's host scans, and the
    packed u32 keys of full lists."""
    blocks, lib, cd, cr, dist, order = _clustered(seed)
    b, t = len(blocks), len(lib) // 2
    calls, kw = [], {}
    if route == "callback":
        host = make_numpy_refill(blocks, lib, k=16)
        kw = dict(refill_cb=_counting(lambda ids, used: host(ids, used.astype(bool)), calls),
                  cb_k=16)
    elif route == "device":
        dev = DeviceRefiller(blocks, lib, k=16)
        kw = dict(refill_cb=_counting(dev, calls), cb_max_batch=dev.max_batch)
    elif route == "dry":
        kw = dict(refill_cb=_counting(_dry(8), calls))
    if route == "keys":
        keys = ((np.take_along_axis(dist, order, axis=1).astype(np.uint32) << np.uint32(8))
                | order.astype(np.uint32))
        run = lambda st: native.greedy_global(keys, None, blocks, lib, t, bits_c=8,  # noqa: E731
                                              stats=st)
    else:
        run = lambda st: native.greedy_global(cd, cr, blocks, lib, t, stats=st, **kw)  # noqa: E731
    plain = run(None)
    n_plain = len(calls)
    stats = {}
    t0 = time.perf_counter()
    got = run(stats)
    wall = time.perf_counter() - t0
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    assert set(stats) == set(native.STATS)
    assigned = int(np.count_nonzero(got[0] >= 0))
    no_candidate = b - assigned  # each popped once, with nothing left to take
    assert (no_candidate > 0) == (route == "dry")
    assert assigned + no_candidate == b
    assert 0 <= stats["engine_requeues"] <= stats["engine_entries"] - assigned
    assert stats["engine_cb_events"] == len(calls) - n_plain == n_plain
    assert (stats["engine_cb_events"] > 0) == (route in ("callback", "device", "dry"))
    assert (stats["engine_cb_s"] > 0) == (stats["engine_cb_events"] > 0)
    assert (stats["engine_gather_s"] > 0) == (stats["engine_cb_events"] > 0)
    assert (stats["refill_host_events"] > 0) == (route == "host")
    assert all(stats[k] >= 0.0 for k in SECONDS)
    assert stats["engine_loop_s"] <= wall
    assert sum(stats[k] for k in SECONDS) <= wall
    again = {}
    run(again)
    for k in ("refill_host_events", "engine_entries", "engine_cb_events", "engine_requeues"):
        assert again[k] == stats[k], k


def test_the_sequence_engine_fills_what_it_has(engine):
    """The in-render engine has no heap and no callback: those slots stay
    0; its own loop and its host scans fit in the call's wall."""
    blocks, lib, cd, cr, _, _ = _clustered(5, b=200)
    order = np.random.default_rng(5).permutation(len(blocks)).astype(np.int32)
    stats = {}
    t0 = time.perf_counter()
    got = native.greedy_sequence(order, cd, cr, blocks, lib, stats=stats)
    wall = time.perf_counter() - t0
    plain = native.greedy_sequence(order, cd, cr, blocks, lib)
    np.testing.assert_array_equal(got[0], plain[0])
    assert set(stats) == set(native.STATS)
    assert all(stats[k] == 0 for k in NO_HEAP)
    assert stats["refill_host_events"] > 0
    assert 0.0 <= stats["engine_loop_s"] and stats["engine_loop_s"] + stats["refill_host_s"] <= wall


@pytest.mark.parametrize("route", ["k12", "stripe"])
def test_the_refiller_waits_once_a_device_call(monkeypatch, route):
    """`wait_s` takes one reading of the clock's pair a device call, on
    K12's route (here its plain version) and on the stripe's (`_K12_MAX_M`
    at 0); a call on an all-used mask reaches no device and waits on
    nothing. A clock that moves one second a reading counts the pairs."""
    blocks, lib, _, _, _, _ = _clustered(7)
    if route == "stripe":
        monkeypatch.setattr(refill, "_K12_MAX_M", 0)
    dev = DeviceRefiller(blocks, lib, k=16)
    used = np.zeros(len(lib), np.uint8)
    used[::3] = 1
    dev(np.arange(4), used)
    assert dev.wait_s > 0.0 and dev.n_calls == 1
    ticks = itertools.count()
    monkeypatch.setattr(refill.time, "perf_counter", lambda: float(next(ticks)))
    dev = DeviceRefiller(blocks, lib, k=16)
    for m in (1, 3, 5):
        dev(np.arange(m), used)
    assert dev.wait_s == dev.n_calls == 3
    assert dev.n_fused == (3 if route == "k12" else 0)
    dev(np.arange(2), np.ones(len(lib), np.uint8))
    assert dev.wait_s == dev.n_calls == 3


def test_a_render_splits_its_engine(monkeypatch, engine):
    """A no-repeat render with device refills on CPU tensors: every
    callback is one `norepeat.refill` span, inside the callback's wall; the
    refill's wait fits in its span; the engine's span holds its loop,
    gathers, callbacks and host scans."""
    rng = np.random.default_rng(11)
    t, dim = 200, 2
    bases = rng.integers(0, 256, size=(25, 1, 3))
    pal = np.clip(np.repeat(bases, 8, axis=0) + rng.integers(-10, 11, size=(t, dim * dim, 3)),
                  0, 255).astype(np.uint8)
    src = np.clip(rng.integers(0, 256, size=(12, 12, 1, 1, 3)).repeat(dim, 2).repeat(dim, 3)
                  .transpose(0, 2, 1, 3, 4).reshape(24, 24, 3)
                  + rng.integers(-6, 7, size=(24, 24, 3)), 0, 255).astype(np.uint8)
    stack = rng.integers(0, 256, size=(t, 4, 4, 3), dtype=np.uint8)
    monkeypatch.setattr(norepeat, "_EXACT_BUDGET", 0)
    monkeypatch.setattr(norepeat, "_TRUNCATED_K", 12)
    monkeypatch.setattr(refill, "_DEVICE_REFILL_MIN_LD", 0)
    ts = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(t)])
    info = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", stack=stack,
                                          log=lambda *a: None).info
    sp = info["spans"]
    assert info["engine_cb_events"] == sp["norepeat.refill"]["n"] == info["refill_events"] > 1
    assert sp["norepeat.refill"]["s"] <= info["engine_cb_s"]
    assert 0.0 < info["refill_wait_s"] <= sp["norepeat.refill"]["s"]
    parts = sum(info[k] for k in SECONDS)
    assert parts <= sp["norepeat.engine"]["s"]
    assert "refill_rows" not in info and "timeline" not in info


def _timeline_and_ranges(body):
    info = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with monitor.record(info):
            body()
    return info, bench_spans.host_spans(prof)


def test_the_timeline_lies_on_the_ranges():
    """One entry a span exit, in the order the spans closed; any two
    entries are disjoint or one holds the other; each entry lies within
    50 us of its `emosaic:` range on the profiler's clock."""
    def body():
        for _ in range(3):
            with monitor.span("a"):
                with monitor.span("b"):
                    torch.ones(256).sum()
        with monitor.span("c"):
            time.sleep(0.002)

    info, host = _timeline_and_ranges(body)
    tl = info["timeline"]
    assert [e[0] for e in tl] == ["b", "a", "b", "a", "b", "a", "c", "render"]
    assert len(tl) == sum(v["n"] for v in info["spans"].values())
    for _, s0, s1 in tl:
        assert s0 <= s1
    for (_, s0, s1), (_, t0, t1) in itertools.combinations(tl, 2):
        assert s1 <= t0 or t1 <= s0 or (s0 <= t0 and t1 <= s1) or (t0 <= s0 and s1 <= t1)
    b_in_a = [(b, a) for b, a in zip(tl[0:6:2], tl[1:6:2])]
    assert all(a[1] <= b[1] and b[2] <= a[2] for b, a in b_in_a)
    assert all(tl[-1][1] <= s0 and s1 <= tl[-1][2] for _, s0, s1 in tl)
    for name in ("render", "a", "b", "c"):
        mine = sorted(e[1:3] for e in tl if e[0] == name)
        theirs = sorted(h[1:] for h in host if h[0] == name)
        assert len(mine) == len(theirs)
        for (s0, s1), (h0, h1) in zip(mine, theirs):
            assert abs(s0 - h0) <= 50 and abs(s1 - h1) <= 50, (name, s0 - h0, s1 - h1)
    c = next(e for e in tl if e[0] == "c")
    assert c[2] - c[1] >= 2000


def test_no_timeline_without_a_profiler_or_a_record():
    """Tracing off adds no key; a render inside another keeps its own
    timeline, rooted at its own `render`; a span outside a record writes
    nothing."""
    info = {}
    with monitor.record(info):
        with monitor.span("x"):
            pass
    assert set(info) == {"spans"}

    def body():
        with monitor.span("outer"):
            inner = {}
            with monitor.record(inner):
                with monitor.span("y"):
                    pass
            body.inner = inner

    outer, _ = _timeline_and_ranges(body)
    assert [e[0] for e in outer["timeline"]] == ["outer", "render"]
    assert [e[0] for e in body.inner["timeline"]] == ["y", "render"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with monitor.span("alone") as sp:
            pass
    assert sp.s >= 0.0
