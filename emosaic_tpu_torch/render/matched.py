"""Matched renderer (reference: rendering.rs:124-230 `render_nto1`).

The torch counterpart of `emosaic_tpu/render/matched.py` for the repeat
path: source -> block vectors (device) -> exact L1 match (the mode-1 LUT,
or the argmin kernel after an optional dedup of repeated blocks) ->
signed item grid -> device composite.

Stats record *source-pixel* coordinates (rendering.rs:211-214), a quirk
kept from the reference.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from emosaic_tpu_torch.ops.analysis import source_blocks, to_device_u8
from emosaic_tpu_torch.ops.composite import compose_mosaic
from emosaic_tpu_torch.ops.distance import build_library, l1_argmin, rows_to_items
from emosaic_tpu_torch.ops.lut import MAX_ROWS, build_l1_lut, lut_match
from emosaic_tpu_torch.stats import RenderStats
from emosaic_tpu_torch.tiles.tileset import TileSet

_LUT_MIN_BLOCKS = 4096  # below this, brute force beats the LUT build cost


@dataclass
class RenderOutcome:
    """Reference RenderResult (rendering.rs:236-243)."""

    image: np.ndarray | None
    stats: RenderStats
    tile_set: TileSet
    items: np.ndarray | None = None  # [vtiles, htiles] signed item grid


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to emosaic_tpu_torch yet (ROADMAP: {item}); "
        "use emosaic_tpu for it"
    )


def start_render(source_img, tile_set, tile_size, log, *, device):
    """Shared render prologue: grid math, the 'Doing WxH tiles...' line,
    and the device blocks and library. Returns
    (dim, htiles, vtiles, blocks, lib)."""
    dim = math.isqrt(tile_set.n_cells)
    h, w = source_img.shape[0], source_img.shape[1]
    htiles, vtiles = w // dim, h // dim
    log(
        f"Doing {htiles}x{vtiles} tiles resulting in a "
        f"{htiles * tile_size}x{vtiles * tile_size} image (step: {dim})"
    )
    blocks = source_blocks(source_img, dim, device=device)  # [B, 3N], y-major
    lib = build_library(to_device_u8(tile_set.palettes, device))  # [2T, 3N]
    return dim, htiles, vtiles, blocks, lib


def finish_render(
    rows, dists, vtiles, htiles, tile_set, stats_step, tile_size, *,
    stack, compose, device,
) -> RenderOutcome:
    """Shared render epilogue: items grid (unassigned -> black), stats,
    optional composite. `rows`, `dists` are host int32 arrays."""
    num_tiles = len(tile_set)
    items = rows_to_items(torch.from_numpy(rows), num_tiles).numpy()
    items = np.where(rows < 0, 0, items)  # unassigned -> black
    items_grid = items.reshape(vtiles, htiles)
    stats = RenderStats.from_grid(
        items_grid,
        np.asarray(dists).reshape(vtiles, htiles),
        stats_step,
        stats_step,
        tile_set,
    )
    image = None
    if compose:
        if stack is None:
            stack = tile_set.image_stack(tile_size)
        image = compose_mosaic(items_grid, stack, device=device)
    return RenderOutcome(
        image=image, stats=stats, tile_set=tile_set, items=items_grid
    )


def match_blocks(
    blocks: torch.Tensor, lib: torch.Tensor, *, use_lut: str = "auto"
) -> tuple[np.ndarray, np.ndarray]:
    """Exact L1 match on the blocks' device: the LUT (mode 1, >= 4096
    blocks, or `use_lut="always"`), else the argmin kernel, with repeated
    blocks deduplicated first when a sample says fewer than half are
    unique. Returns host (dist [B] int32, row [B] int32)."""
    b, d = blocks.shape
    lut_ok = d == 3 and lib.shape[0] <= MAX_ROWS
    lut_auto = use_lut == "auto" and lut_ok and b >= _LUT_MIN_BLOCKS
    if use_lut == "always" or lut_auto:
        if not lut_ok:
            raise ValueError("LUT path requires mode 1 and a small-enough library")
        lut = build_l1_lut(lib, device=blocks.device)
        dist, row = lut_match(blocks, lut)
        return dist.cpu().numpy(), row.cpu().numpy()
    # Dedup identical query blocks before the dense kernel (sources repeat
    # colours heavily). Sample first: a full unique over 16M rows isn't free.
    if b > 8192:
        sample = blocks[:: max(1, b // 4096)]
        est = len(torch.unique(sample, dim=0)) / len(sample)
        if est < 0.5:
            uniq, inverse = torch.unique(blocks, dim=0, return_inverse=True)
            du, ru = l1_argmin(uniq, lib)
            return du[inverse].cpu().numpy(), ru[inverse].cpu().numpy()
    dist, row = l1_argmin(blocks, lib)
    return dist.cpu().numpy(), row.cpu().numpy()


def render_nto1(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    no_repeat: bool = False,
    randomize: float | None = None,
    *,
    device,
    use_lut: str = "auto",
    stack: np.ndarray | None = None,
    compose: bool = True,
    log=lambda *a: print(*a, file=sys.stderr),
) -> RenderOutcome:
    """Render the matched (repeat) mosaic of `source_img` on `device`."""
    if no_repeat:
        raise _not_ported("--no-repeat", "render/norepeat.py + greedy.py")
    if randomize is not None:
        raise _not_ported("--randomize", "ops/distance.py slice B (exact top-k)")
    if len(tile_set) == 0:
        # the reference panics deep in the kd-tree here; fail clearly
        raise ValueError("❌ No tiles available for matching")
    dim, htiles, vtiles, blocks, lib = start_render(
        source_img, tile_set, tile_size, log, device=device
    )
    dists, rows = match_blocks(blocks, lib, use_lut=use_lut)
    # stats_step=dim: source-pixel coords (rendering.rs:211-214)
    return finish_render(
        rows, dists, vtiles, htiles, tile_set, dim, tile_size,
        stack=stack, compose=compose, device=device,
    )
