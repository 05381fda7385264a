"""Random-mode renderer (reference: rendering.rs:418-440 `render_random`).

The torch counterpart of `emosaic_tpu/render/random_mode.py`. Each source
pixel becomes a uniformly random tile; no analysis, no stats. The items
come from numpy's generator with an explicit seed, so they equal the JAX
package's for the same seed (the reference's thread_rng is
irreproducible); the composite is `compose_mosaic` (kernel K2 on the card).
"""

from __future__ import annotations

import numpy as np

from emosaic_tpu_torch.ops.composite import compose_mosaic
from emosaic_tpu_torch.tiles.tileset import TileSet


def random_items(shape, num_tiles: int, seed: int) -> np.ndarray:
    """The seeded [h, w] grid of 1-based tile ids, never flipped."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, num_tiles + 1, size=shape, dtype=np.int32)


def render_random(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    *,
    device,
    seed: int = 0,
    stack: np.ndarray | None = None,
) -> np.ndarray:
    """The [h*ts, w*ts, 3] uint8 mosaic of one random tile per pixel of
    `source_img`, composed on `device`."""
    if len(tile_set) == 0:
        raise ValueError("empty tile set")
    items = random_items(source_img.shape[:2], len(tile_set), seed)
    if stack is None:
        stack = tile_set.image_stack(tile_size)
    return compose_mosaic(items, stack, device=device)
