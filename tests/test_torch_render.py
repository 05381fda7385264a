"""Port parity: `emosaic_tpu_torch.render.matched` against the JAX package.

In-memory tile sets (`TileSet.from_arrays`), no files: the item grid,
the distances and the composite must equal `emosaic_tpu`'s exactly on
each match route (LUT, dedup + argmin, dense argmin).
"""

import numpy as np
import pytest

from emosaic_tpu.render import matched as jax_matched
from emosaic_tpu.tiles.tileset import TileSet as JaxTileSet
from emosaic_tpu_torch.ops.analysis import source_blocks, to_device_u8
from emosaic_tpu_torch.ops.distance import build_library
from emosaic_tpu_torch.render import matched
from emosaic_tpu_torch.tiles.tileset import TileSet


def _sets(rng, t, n_cells):
    pal = rng.integers(0, 256, size=(t, n_cells, 3), dtype=np.uint8)
    paths = [f"tiles/t{i}.jpg" for i in range(t)]
    return TileSet.from_arrays(pal, paths), JaxTileSet.from_tiles(pal, paths)


@pytest.mark.parametrize(
    "dim,h,w,use_lut",
    [
        (1, 64, 80, "auto"),  # 5120 blocks: the LUT
        (1, 32, 40, "auto"),  # 1280 blocks: the argmin
        (1, 16, 16, "always"),  # --matcher lut below the cutoff
        (1, 64, 80, "never"),  # --matcher pallas above it
        (2, 24, 30, "auto"),
        (4, 32, 48, "auto"),
    ],
)
def test_render_nto1_matches_jax(rng, dim, h, w, use_lut):
    ts, jts = _sets(rng, 30, dim * dim)
    src = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(30, 8, 8, 3), dtype=np.uint8)
    got = matched.render_nto1(
        src, ts, 8, device="cpu", use_lut=use_lut, stack=stack, log=lambda *a: None
    )
    want = jax_matched.render_nto1(
        src, jts, 8, use_lut=use_lut, stack=stack, log=lambda *a: None
    )
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.stats.render(8), want.stats.render(8))


def test_match_blocks_dedup_route_matches_jax(rng):
    # > 8192 blocks with few distinct ones: both take the dedup route
    ts, _ = _sets(rng, 50, 4)
    src = rng.integers(0, 256, size=(6, 2, 3), dtype=np.uint8)
    img = np.tile(src, (64, 64, 1))  # 384x128: 12288 blocks of 2x2, 3 distinct
    blocks = source_blocks(img, 2, device="cpu")
    lib = build_library(to_device_u8(ts.palettes, "cpu"))
    assert blocks.shape[0] > 8192
    d, r = matched.match_blocks(blocks, lib)
    jd, jr = jax_matched.match_blocks(blocks.numpy(), lib.numpy())
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(r, jr)


def test_render_refuses_unported_routes_and_empty_sets(rng):
    """No route of `render_nto1` is unported any more: what it refuses is
    what the JAX package refuses (no-repeat with randomize, an empty set)."""
    ts, _ = _sets(rng, 4, 1)
    src = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="deadlocks"):
        matched.render_nto1(src, ts, 8, no_repeat=True, randomize=10.0, device="cpu")
    empty = TileSet.from_arrays(np.zeros((0, 1, 3), np.uint8), [])
    with pytest.raises(ValueError, match="No tiles"):
        matched.render_nto1(src, empty, 8, device="cpu")


@pytest.mark.parametrize("route,engine", [("match", None), ("randomize", None),
                                          ("greedy", "native"), ("greedy", "python")])
@pytest.mark.parametrize("compose", [True, False])
def test_render_nto1_records_its_stages(rng, monkeypatch, route, engine, compose):
    from emosaic_tpu_torch import native

    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    ts, _ = _sets(rng, 40, 4)
    src = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(40, 8, 8, 3), dtype=np.uint8)
    got = matched.render_nto1(
        src, ts, 8, device="cpu", stack=stack, compose=compose, log=lambda *a: None,
        randomize=10.0 if route == "randomize" else None, no_repeat=route == "greedy",
    )
    want = {"render", "render.prologue", "prologue.library", "render.match", "render.stats"}
    # the in-render no-repeat route's stages, under render.match
    seq = {"sequence.scoring", "sequence.to_host", "sequence.engine"} if route == "greedy" else set()
    # the library's and the stack's way to the device, under render.prologue
    # and render.compose
    inner = seq | {"prologue.library", "compose.stack"}
    assert set(got.info["spans"]) == (want | seq
                                      | ({"render.compose", "compose.stack"} if compose else set()))
    spans = got.info["spans"]
    assert all(e["n"] == 1 and 0 <= e["self_s"] <= e["s"] for e in spans.values())
    assert spans["render"]["s"] >= sum(spans[k]["s"] for k in spans
                                       if k != "render" and k not in inner)
    assert spans["render.match"]["s"] >= sum(spans[k]["s"] for k in seq)
    assert spans["render.prologue"]["s"] >= spans["prologue.library"]["s"]
    if compose:
        assert spans["render.compose"]["s"] >= spans["compose.stack"]["s"]
