"""The render's record of its match and of its uploads.

`render_nto1`'s `info["match"]` on each route of `match_blocks` (the
route, the blocks, the rows the argmin scored, the library's rows and
width; K1's launch shape only where K1 runs, so not on the CPU), and the
spans `prologue.library` (the palettes to the device and their mirrors)
and `compose.stack` (the tile stack to the device and its mirrors) inside
`render.prologue` and `render.compose` of both renderers.
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops.analysis import source_blocks, to_device_u8
from emosaic_tpu_torch.ops.distance import build_library
from emosaic_tpu_torch.parallel import make_mesh
from emosaic_tpu_torch.render import matched, norepeat
from emosaic_tpu_torch.tiles.tileset import TileSet

quiet = {"log": lambda *a: None}

#: route -> (mode, photo height, photo width, render_nto1's keywords)
ROUTES = {
    "lut": (1, 16, 16, {"use_lut": "always"}),
    "argmin": (2, 24, 30, {}),
    "argmin_dedup": (2, 384, 128, {}),
    "l2": (2, 24, 30, {"metric": "l2"}),
    "hybrid": (2, 24, 30, {"hybrid": True}),
    "mesh": (2, 24, 32, {}),
}


def _scene(rng, t, dim, h, w, route=None):
    pal = rng.integers(0, 256, size=(t, dim * dim, 3), dtype=np.uint8)
    ts = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(t)])
    if route == "argmin_dedup":
        # 12288 blocks of 2 x 2 from 3 distinct ones: the dedup gate fires
        src = np.tile(rng.integers(0, 256, size=(6, 2, 3), dtype=np.uint8), (64, 64, 1))
    else:
        src = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, 4, 4, 3), dtype=np.uint8)
    return ts, src, stack


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_records_its_match(rng, route):
    dim, h, w, kw = ROUTES[route]
    ts, src, stack = _scene(rng, 40, dim, h, w, route)
    if route == "mesh":
        kw = {"mesh": make_mesh(8, model=2, devices=[torch.device("cpu")] * 8)}
    got = matched.render_nto1(src, ts, 4, device="cpu", stack=stack, **kw, **quiet)
    b = (h // dim) * (w // dim)
    scored = len(np.unique(src.reshape(h // dim, dim, w // dim, dim, 3)
                           .transpose(0, 2, 1, 3, 4).reshape(b, -1), axis=0))
    want = {"route": route, "blocks": b, "scored": scored if route == "argmin_dedup" else b,
            "rows": 80, "width": dim * dim * 3}
    assert got.info["match"] == want  # no `k1`: K1 does not run on the CPU
    if route == "argmin_dedup":
        assert scored == 3


@pytest.mark.parametrize("route", ["lut", "argmin"])
def test_match_blocks_records_into_the_given_dict_only(rng, route):
    """`match_blocks` fills the `stats` it is given, and runs alike without
    one; the other routes of `render_nto1` record no match."""
    dim, h, w, kw = ROUTES[route]
    ts, src, stack = _scene(rng, 200, dim, h, w)  # T >= B: room for the no-repeat render
    blocks = source_blocks(src, dim, device="cpu")
    lib = build_library(to_device_u8(ts.palettes, "cpu"))
    stats = {}
    with_stats = matched.match_blocks(blocks, lib, stats=stats, **kw)
    without = matched.match_blocks(blocks, lib, **kw)
    np.testing.assert_array_equal(with_stats[0], without[0])
    np.testing.assert_array_equal(with_stats[1], without[1])
    assert stats["route"] == route and stats["blocks"] == blocks.shape[0]
    for other in ({"randomize": 10.0}, {"no_repeat": True}):
        got = matched.render_nto1(src, ts, 4, device="cpu", stack=stack, **other, **quiet)
        assert "match" not in got.info


@pytest.mark.parametrize("renderer", ["render_nto1", "render_nto1_no_repeat"])
@pytest.mark.parametrize("compose", [True, False])
def test_the_uploads_are_spans_of_both_renderers(rng, renderer, compose):
    ts, src, stack = _scene(rng, 60, 2, 16, 20)
    render = (matched.render_nto1 if renderer == "render_nto1"
              else norepeat.render_nto1_no_repeat)
    spans = render(src, ts, 4, device="cpu", stack=stack, compose=compose, **quiet).info["spans"]
    pairs = [("render.prologue", "prologue.library")]
    if compose:
        pairs.append(("render.compose", "compose.stack"))
    else:
        assert "compose.stack" not in spans and "render.compose" not in spans
    for parent, child in pairs:
        assert spans[child]["n"] == spans[parent]["n"] == 1
        assert 0 < spans[child]["s"] <= spans[parent]["s"]
        # the child is its parent's only child
        assert spans[parent]["self_s"] == pytest.approx(spans[parent]["s"] - spans[child]["s"])

