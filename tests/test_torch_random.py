"""Port parity: random mode (`render_random`) against the JAX package.

The item grid comes from numpy's generator with the caller's seed in both
packages, so the composite must be equal byte for byte; the composite is
K2's plain version here (`compose_rows_ref`, a CPU tensor).
"""

from pathlib import Path

import numpy as np
import pytest

from emosaic_tpu.render.random_mode import render_random as jax_render_random
from emosaic_tpu.tiles.tileset import TileSet as JaxTileSet
from emosaic_tpu_torch.render.random_mode import random_items, render_random
from emosaic_tpu_torch.tiles.tileset import TileSet


def _sets(n):
    paths = [Path(f"{i}.jpg") for i in range(n)]
    return TileSet(palettes=None, paths=paths), JaxTileSet(palettes=None, paths=paths)


@pytest.mark.parametrize("h,w,t,ts,seed", [(10, 10, 3, 32, 7), (7, 13, 40, 8, 0),
                                           (1, 1, 1, 4, 3)])
def test_render_random_matches_jax(rng, h, w, t, ts, seed):
    src = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    ts_p, ts_j = _sets(t)
    got = render_random(src, ts_p, ts, stack=stack, seed=seed, device="cpu")
    want = np.asarray(jax_render_random(src, ts_j, ts, stack=stack, seed=seed))
    assert got.shape == (h * ts, w * ts, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, render_random(src, ts_p, ts, stack=stack, seed=seed, device="cpu")
    )


def test_random_items_are_the_seeded_grid_and_never_flipped():
    items = random_items((50, 60), 9, 11)
    want = np.random.default_rng(11).integers(1, 10, size=(50, 60), dtype=np.int32)
    np.testing.assert_array_equal(items, want)
    assert items.min() >= 1 and items.max() <= 9


def test_render_random_refuses_an_empty_tile_set():
    with pytest.raises(ValueError, match="empty"):
        render_random(np.zeros((2, 2, 3), np.uint8), TileSet(palettes=None, paths=[]), 8,
                      device="cpu")
