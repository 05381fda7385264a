"""The no-repeat render's exact-full route (`render_nto1_no_repeat` while
B * L fits `_EXACT_BUDGET`: the dense matrix, each row sorted (K13 on the
card, its plain version here), the engine on full lists) against the
benchmark's plain reference (`bench_torch/reference.py`, the global greedy
and the composite), items and image bytes exactly, on the CPU; its spans and counters, the
benchmark's readers of them, and the `service_m16` configuration's hold on
the route.
"""

import numpy as np
import pytest
import torch

from bench_torch import harness, reference, spec
from bench_torch.scene import sizes
from emosaic_tpu_torch import native
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.render import norepeat
from emosaic_tpu_torch.tiles.tileset import TileSet

quiet = dict(log=lambda *a: None)
TS = 8
#: (tiles, photo side in blocks): every tile used (B = T), or fewer blocks
#: than tiles
CASES = {"full": (64, 8), "fewer": (96, 8), "ties": (64, 8)}


def _scene(seed, dim, case, t=None, side=None):
    """Palettes [T, dim*dim, 3], a photo of side*dim pixels square and the
    tile stack; T and side are the case's unless given. "ties": palettes
    and photo quantised to three levels a channel, one colour a tile, so
    tiles share distances with each other, with their own mirrors and
    across blocks."""
    rng = np.random.default_rng(seed)
    t, side = t or CASES[case][0], side or CASES[case][1]
    n, h = dim * dim, side * dim
    if case == "ties":
        pal = np.repeat(rng.integers(0, 3, size=(t, 1, 3)) * 127, n, axis=1).astype(np.uint8)
        src = (rng.integers(0, 3, size=(side, side, 3)) * 127).astype(np.uint8)
        src = src.repeat(dim, 0).repeat(dim, 1)
    else:
        bases = rng.integers(0, 256, size=(t, 1, 3))
        pal = np.clip(bases + rng.integers(-10, 11, size=(t, n, 3)), 0, 255).astype(np.uint8)
        src = rng.integers(0, 256, size=(h, h, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, TS, TS, 3), dtype=np.uint8)
    return pal, src, stack


def _render(pal, src, stack):
    ts = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(len(pal))])
    return norepeat.render_nto1_no_repeat(src, ts, TS, device="cpu", stack=stack, **quiet)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_full_matches_the_plain_reference(monkeypatch, seed, dim, case, engine):
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    pal, src, stack = _scene(seed, dim, case)
    got = _render(pal, src, stack)
    assert got.info["scorer"] == "exact-full" and got.info["engine"] == engine
    items, image = reference.render(torch.from_numpy(src), torch.from_numpy(pal),
                                    torch.from_numpy(stack), dim, reference.greedy)
    np.testing.assert_array_equal(got.items, items.numpy())
    np.testing.assert_array_equal(np.asarray(got.image), image.numpy())
    t, side = CASES[case]
    assert np.count_nonzero(got.items) == min(t, side * side)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_exact_full_spans_and_counters(monkeypatch, engine):
    """`scoring.dense` and `scoring.sort` are `norepeat.scoring`'s children
    and hold all but 1% of it; the route's statistics; the native engine's
    candidate entries, none from the Python engine. 256 blocks: the
    scoring's ~0.1 s outweighs the spans' own few tens of microseconds."""
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    pal, src, stack = _scene(3, 16, "full", t=256, side=16)
    got = _render(pal, src, stack)
    info, spans = got.info, got.info["spans"]
    b, l, d = got.items.size, 2 * len(pal), pal[0].size
    key_bytes = 4 if (255 * d).bit_length() + (l - 1).bit_length() <= 32 else 8
    assert key_bytes == 4  # 18 distance bits (D = 768) and 9 row bits (L = 512)
    assert info["scoring"] == {"route": "exact-full", "pairs": b * l, "matrix_bytes": 4 * b * l,
                               "sort": "plain", "key_bytes": key_bytes}
    parts = spans["scoring.dense"]["s"] + spans["scoring.sort"]["s"]
    assert spans["scoring.dense"]["n"] == spans["scoring.sort"]["n"] == 1
    assert spans["norepeat.scoring"]["self_s"] == pytest.approx(
        spans["norepeat.scoring"]["s"] - parts)
    assert parts <= spans["norepeat.scoring"]["s"] <= 1.01 * parts
    if engine == "native":
        assert info["engine_entries"] >= b
    else:
        assert "engine_entries" not in info


def test_exact_full_entries_count_the_skipped_entries():
    """Two blocks that want the same tile: the later one reads the taken
    tile's row and its mirror before its own; every entry of a full list is
    counted once."""
    if not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    pal = np.array([[[10, 10, 10]], [[200, 200, 200]]], np.uint8)  # T = 2, dim = 1
    lib = np.concatenate([pal.reshape(2, 3), pal.reshape(2, 3)])  # a 1-cell mirror is itself
    blocks = np.array([[12, 12, 12], [11, 11, 11]], np.uint8)
    dist = np.abs(blocks[:, None].astype(np.int32) - lib[None]).sum(2).astype(np.int32)
    cr = np.argsort(dist, axis=1, kind="stable").astype(np.int32)
    cd = np.take_along_axis(dist, cr, axis=1)
    stats = {}
    rows, _ = native.greedy_global(cd, cr, blocks, lib, 2, stats=stats)
    # block 1 takes row 0; block 0 skips rows 0 and 2 (its mirror), takes row 1
    assert rows.tolist() == [1, 0]
    assert stats["engine_entries"] == 1 + 3


def _run(records, b=4096):
    cfg = {"mode": 16, "tile_size": 32, "tiles": b, "source_height": 1024,
           "source_width": 1024}
    run = harness.Run(cell={}, cfg=cfg, traffic={}, sizes=sizes(cfg), scene=None,
                      device=torch.device("cpu"), base=spec.HERE)
    run.records = [harness.Record(0, 1.0, 1, True, info) for info in records]
    return run


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


def test_the_new_metric_readers():
    spans = {"scoring.dense": {"s": 0.1, "self_s": 0.1, "n": 1},
             "scoring.sort": {"s": 3.0, "self_s": 3.0, "n": 1}}
    run = _run([{"spans": spans, "engine_entries": 4096 * 10},
                {"spans": {"scoring.dense": {"s": 0.3, "self_s": 0.3, "n": 1},
                           "scoring.sort": {"s": 3.4, "self_s": 3.4, "n": 1}},
                 "engine_entries": 4096 * 30}])
    assert _read("scoring.dense_s", run) == pytest.approx(0.2)
    assert _read("scoring.sort_s", run) == pytest.approx(3.2)
    assert _read("norepeat.entries_per_block", run) == pytest.approx(20.0)
    # a window of another route, or of the Python engine: nothing to read
    empty = _run([{"spans": {"norepeat.scoring": {"s": 1.0, "self_s": 1.0, "n": 1}}}, None])
    for name in ("scoring.dense_s", "scoring.sort_s", "norepeat.entries_per_block"):
        assert _read(name, empty) is None
        assert _read(name, _run([])) is None


def test_the_service_m16_cell_stays_on_the_exact_full_route():
    """The configuration's sizes keep its cell on the route it measures: B * L
    within `_EXACT_BUDGET` and the library within the device budget."""
    bench = spec.load_benchmark()
    cell = bench.cell("service_m16.exact_full")
    cfg = spec.config_of(bench, cell)
    assert cfg["entry"] == "emosaic_tpu_torch.render.norepeat:render_nto1_no_repeat"
    assert cfg["render"] == {} and cfg["reference"] == "l1_greedy"
    sz = sizes(cfg)
    assert (sz["B"], sz["L"], sz["D"]) == (4096, 8192, 768)
    assert sz["B"] * sz["L"] <= norepeat._EXACT_BUDGET
    assert sz["L"] * sz["D"] <= distance.DEVICE_LIB_BYTES_MAX
    assert sz["B"] == sz["T"]  # every tile placed once

