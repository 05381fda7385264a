"""The in-render no-repeat render (`render_nto1(no_repeat=True)`, upstream's
`--no-repeat --greedy`: the blocks in render order, each taking its nearest
unused library row, only that orientation removed) against the benchmark's
plain reference (`bench_torch/semantics/l1_sequence.py` on
`bench_torch/reference.py`), items and image bytes exactly, on the CPU, with
the native and the Python engine; the render's spans and the engines'
counters; and the reference against a brute-force loop.
"""

import numpy as np
import pytest
import torch

from bench_torch import reference, spec
from emosaic_tpu_torch import native
from emosaic_tpu_torch.render import matched
from emosaic_tpu_torch.render.greedy import greedy_sequence_assign, make_numpy_refill
from emosaic_tpu_torch.tiles.tileset import TileSet

quiet = dict(log=lambda *a: None)
TS = 8
#: (tiles, photo height and width in blocks): blocks far fewer than the
#: library's rows, or nearly all of them (B close to 2T, so late blocks
#: find their 64-entry lists used up and the engine scans the library)
CASES = {"clustered": (90, 6, 8), "ties": (60, 6, 8), "near_full": (100, 14, 14)}
SPANS = ("sequence.scoring", "sequence.to_host", "sequence.engine")
COUNTERS = ("refill_host_events", "refill_host_s", "engine_entries")

sequence = spec.load_module("semantics", "l1_sequence")


def _scene(seed, dim, case):
    """Palettes [T, dim*dim, 3], a photo and the tile stack. "clustered" and
    "near_full": tiles in runs of similar colours, and a smooth photo, so
    neighbouring blocks want the same tiles. "ties": palettes and photo
    quantised to three levels a channel, one colour a tile, so tiles share
    distances with each other, with their own mirrors and across blocks."""
    rng = np.random.default_rng(seed)
    t, gh, gw = CASES[case]
    n = dim * dim
    if case == "ties":
        pal = np.repeat(rng.integers(0, 3, size=(t, 1, 3)) * 127, n, axis=1).astype(np.uint8)
        src = (rng.integers(0, 3, size=(gh, gw, 3)) * 127).astype(np.uint8)
        src = src.repeat(dim, 0).repeat(dim, 1)
    else:
        bases = rng.integers(0, 256, size=(-(-t // 8), 1, 3))
        pal = np.clip(np.repeat(bases, 8, axis=0)[:t] + rng.integers(-10, 11, size=(t, n, 3)),
                      0, 255).astype(np.uint8)
        y, x = np.mgrid[0 : gh * dim, 0 : gw * dim]
        ramp = np.stack([x * 255 // (gw * dim), y * 255 // (gh * dim), (x + y) % 256], -1)
        src = np.clip(ramp + rng.integers(-6, 7, size=ramp.shape), 0, 255).astype(np.uint8)
    stack = rng.integers(0, 256, size=(t, TS, TS, 3), dtype=np.uint8)
    return pal, src, stack


def _engine(monkeypatch, engine):
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")


def _render(pal, src, stack, seed):
    ts = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(len(pal))])
    return matched.render_nto1(src, ts, TS, no_repeat=True, seed=seed, device="cpu",
                               stack=stack, **quiet)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_in_render_no_repeat_matches_the_plain_reference(monkeypatch, seed, dim, case, engine):
    _engine(monkeypatch, engine)
    pal, src, stack = _scene(seed, dim, case)
    got = _render(pal, src, stack, seed)
    items, image = sequence.render(torch.from_numpy(src), torch.from_numpy(pal),
                                   torch.from_numpy(stack),
                                   {"mode": dim, "render": {"seed": seed}})
    np.testing.assert_array_equal(got.items, items.numpy())
    np.testing.assert_array_equal(np.asarray(got.image), image.numpy())
    # every block placed, no row twice; a tile may appear with its mirror
    assert np.count_nonzero(got.items) == got.items.size
    assert len(set(got.items.reshape(-1).tolist())) == got.items.size


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_and_counters_on_every_render(monkeypatch, case, engine):
    """The three spans are `render.match`'s children, once each, and the
    render's `info` holds the engine's three counters; at near-full
    consumption the engine scans the library."""
    _engine(monkeypatch, engine)
    pal, src, stack = _scene(4, 4, case)
    info = _render(pal, src, stack, 4).info
    spans = info["spans"]
    assert all(spans[name]["n"] == 1 for name in SPANS)
    parts = sum(spans[name]["s"] for name in SPANS)
    assert parts <= spans["render.match"]["s"]
    assert spans["render.match"]["self_s"] == pytest.approx(spans["render.match"]["s"] - parts)
    assert set(COUNTERS) <= set(info)
    b = CASES[case][1] * CASES[case][2]
    assert info["engine_entries"] >= b
    assert (info["refill_host_events"] > 0) == (case == "near_full")
    assert info["refill_host_s"] >= 0.0
    assert (info["refill_host_s"] > 0.0) == (info["refill_host_events"] > 0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_both_engines_count_alike(monkeypatch, case, seed):
    """The native and the Python engine give the same rows, host scans and
    entries on the same lists."""
    if not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    pal, src, stack = _scene(seed, 4, case)
    got = {}
    for engine in ("native", "python"):
        with monkeypatch.context() as m:
            if engine == "python":
                m.setattr(native, "available", lambda: False)
            out = _render(pal, src, stack, seed)
        got[engine] = (out.items, out.info["refill_host_events"], out.info["engine_entries"])
    np.testing.assert_array_equal(got["native"][0], got["python"][0])
    assert got["native"][1:] == got["python"][1:]


def _lists(seed, b=76, t=40, d=12, k=4):
    """Blocks, the library and each block's k nearest (distance, row), with
    B close to 2T so that lists run dry."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    pal = rng.integers(0, 256, size=(t, d), dtype=np.uint8)
    lib = np.concatenate([pal, pal[:, ::-1]])
    dist = np.abs(blocks[:, None].astype(np.int32) - lib[None].astype(np.int32)).sum(2)
    cr = np.argsort(dist, axis=1, kind="stable")[:, :k].astype(np.int32)
    cd = np.take_along_axis(dist, cr, axis=1).astype(np.int32)
    return rng.permutation(b).astype(np.int32), cd, cr, blocks, lib


@pytest.mark.parametrize("seed", [0, 1])
def test_stats_leave_rows_and_dists_unchanged(seed):
    order, cd, cr, blocks, lib = _lists(seed)
    want = greedy_sequence_assign(order, cd, cr, len(lib), make_numpy_refill(blocks, lib))
    stats = {}
    got = greedy_sequence_assign(order, cd, cr, len(lib), make_numpy_refill(blocks, lib),
                                 stats=stats)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert stats["refill_host_events"] > 0 and stats["engine_entries"] >= len(order)
    if not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    plain = native.greedy_sequence(order, cd, cr, blocks, lib)
    nstats = {}
    counted = native.greedy_sequence(order, cd, cr, blocks, lib, stats=nstats)
    for a, b, c in zip(want, plain, counted):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert set(nstats) == set(native.STATS) and set(COUNTERS) <= set(nstats)
    assert (nstats["refill_host_events"], nstats["engine_entries"]) == (
        stats["refill_host_events"], stats["engine_entries"])


def _brute_force(x, lib, order):
    """Each block in `order` takes the unused row at the least L1 distance,
    the lowest row among equal ones; -1 when none is left."""
    d = np.abs(x.astype(np.int64)[:, None] - lib.astype(np.int64)[None]).sum(-1)
    out, used = np.full(len(x), -1), np.zeros(len(lib), bool)
    for blk in order:
        free = [(int(d[blk, r]), r) for r in range(len(lib)) if not used[r]]
        if free:
            out[blk] = min(free)[1]
            used[out[blk]] = True
    return out


@pytest.mark.parametrize("path", ["thermometer", "cdist"])
@pytest.mark.parametrize("trial", range(4))
def test_the_reference_against_brute_force(monkeypatch, path, trial):
    """Trials 0-1 random bytes, trial 2 three levels a byte (a tie storm),
    trial 3 more blocks than rows (the last blocks black)."""
    if path == "cdist":
        monkeypatch.setattr(reference, "_THERMO_MAX_D", 0)
    rng = np.random.default_rng(trial)
    b, l = (30, 12) if trial == 3 else (20, 24)
    hi = 3 if trial == 2 else 256
    x = rng.integers(0, hi, size=(b, 12)).astype(np.uint8) * (127 if trial == 2 else 1)
    lib = rng.integers(0, hi, size=(l, 12)).astype(np.uint8) * (127 if trial == 2 else 1)
    order = sequence.order(5, b // 5, trial)
    got = sequence.sequence(torch.from_numpy(x), torch.from_numpy(lib), order)
    np.testing.assert_array_equal(got.numpy(), _brute_force(x, lib, order))
    if trial == 3:
        assert (got.numpy() == -1).sum() == b - l

