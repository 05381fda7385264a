"""Port parity: `emosaic_tpu_torch.ops.analysis` against the JAX package.

The same numpy-seeded tiles go through both; every comparison is exact
(the results are uint8 box means and raw source bytes).
"""

import numpy as np
import pytest
import torch

from emosaic_tpu.ops import analysis as jax_analysis
from emosaic_tpu_torch.ops import analysis


@pytest.mark.parametrize("dim", [1, 2, 4, 8])
@pytest.mark.parametrize("h,w", [(16, 16), (19, 23), (8, 13)])
def test_analyse_batch_matches_jax(rng, dim, h, w):
    tiles = rng.integers(0, 256, size=(6, h, w, 3), dtype=np.uint8)
    tiles[0] = 255  # extreme colours: the int32 sum path at its top
    tiles[1] = 0
    tiles[2, ::2] = 255  # trailing rows/cols of odd sizes are dropped
    want = np.asarray(jax_analysis.analyse_batch(tiles, dim))
    got = analysis.analyse_batch(tiles, dim, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (6, dim * dim, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_analyse_one_matches_jax(rng):
    tile = rng.integers(0, 256, size=(11, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        analysis.analyse_one(tile, 2, device="cpu"),
        jax_analysis.analyse_one(tile, 2),
    )


@pytest.mark.parametrize("dim", [1, 2, 4, 8])
def test_source_blocks_matches_jax(rng, dim):
    img = rng.integers(0, 256, size=(dim * 5, dim * 7, 3), dtype=np.uint8)
    img[0, :] = 255
    want = np.asarray(jax_analysis.source_blocks(img, dim))
    got = analysis.source_blocks(img, dim, device="cpu")
    assert got.shape == (35, dim * dim * 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_analysis_rejects_what_jax_rejects(rng):
    with pytest.raises(ValueError, match="smaller than"):
        analysis.analyse_batch(np.zeros((1, 3, 3, 3), np.uint8), 4, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        analysis.source_blocks(np.zeros((5, 4, 3), np.uint8), 2, device="cpu")
