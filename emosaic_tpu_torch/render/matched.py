"""Matched renderer (reference: rendering.rs:124-230 `render_nto1`).

The torch counterpart of `emosaic_tpu/render/matched.py`: source -> block
vectors (device) -> exact L1 match (the mode-1 LUT, or the argmin kernel
after an optional dedup of repeated blocks), or exact top-k candidates
and a randomized or in-render no-repeat choice -> signed item grid ->
device composite. The opt-in fast modes beside the exact match: the
hybrid (an L2 prefilter and an exact-L1 rescore) and the squared-L2
argmin, both approximate.

Parity notes (as in the JAX package):
- stats record *source-pixel* coordinates (rendering.rs:211-214), a quirk
  kept from the reference (the global no-repeat renderer records output
  coordinates).
- `--randomize f`: 20 nearest, keep the ascending prefix with
  `dist - min < f% * min`, choose uniformly (rendering.rs:168-185); the
  best match is always eligible (the reference panics when min == 0), and
  the choice uses an explicit seed.
- `--no-repeat --greedy` removes only the chosen orientation, in render
  order (rendering.rs:163-167, :207-209): rows in sequence, a seeded
  shuffle within each row (rendering.rs:73-74).
- `--no-repeat --randomize` deadlocks the reference (rendering.rs:163-174);
  here it raises ValueError.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from emosaic_tpu_torch.monitor import record, span
from emosaic_tpu_torch.ops import copies
from emosaic_tpu_torch.ops.analysis import source_blocks
from emosaic_tpu_torch.ops.composite import compose_mosaic
from emosaic_tpu_torch.ops.distance import (
    build_library,
    l1_argmin,
    l1_argmin_hybrid,
    l1_topk,
    l2_argmin,
    rows_to_items,
)
from emosaic_tpu_torch.ops.lut import MAX_ROWS, build_l1_lut, lut_match
from emosaic_tpu_torch.render.greedy import greedy_sequence_assign, make_numpy_refill
from emosaic_tpu_torch.stats import RenderStats
from emosaic_tpu_torch.tiles.tileset import TileSet

_DEFAULT_RANDOM_NEIGHBORS = 20  # RenderConfig (rendering.rs:29-36)
_GREEDY_TOPK = 64
_LUT_MIN_BLOCKS = 4096  # below this, brute force beats the LUT build cost


@dataclass
class RenderOutcome:
    """Reference RenderResult (rendering.rs:236-243)."""

    image: np.ndarray | None
    stats: RenderStats
    tile_set: TileSet
    items: np.ndarray | None = None  # [vtiles, htiles] signed item grid
    info: dict | None = None  # the render's record: stage spans, counters


def insufficient_tiles_check(n_blocks: int, n_tiles: int) -> None:
    """rendering.rs:150-156 / :288-294."""
    if n_blocks > n_tiles * 2:
        raise ValueError(
            f"❌ Insufficient tiles for no-repeat mode: need {n_blocks} tiles "
            f"but only have {n_tiles * 2} available"
        )


def start_render(source_img, tile_set, tile_size, log, *, device, check_tiles=False):
    """Shared render prologue (both renderers): grid math, the 'Doing WxH
    tiles...' line, the no-repeat tile-count check, and the device blocks
    and library. Returns (dim, htiles, vtiles, blocks, lib)."""
    dim = math.isqrt(tile_set.n_cells)
    h, w = source_img.shape[0], source_img.shape[1]
    htiles, vtiles = w // dim, h // dim
    log(
        f"Doing {htiles}x{vtiles} tiles resulting in a "
        f"{htiles * tile_size}x{vtiles * tile_size} image (step: {dim})"
    )
    if check_tiles:
        insufficient_tiles_check(htiles * vtiles, len(tile_set))
    with span("render.prologue"):
        blocks = source_blocks(source_img, dim, device=device)  # [B, 3N], y-major
        with span("prologue.library"):  # the palettes to the device and their mirrors
            lib = build_library(copies.to_device_kept(tile_set.palettes, device))  # [2T, 3N]
    return dim, htiles, vtiles, blocks, lib


def finish_render(
    rows, dists, vtiles, htiles, tile_set, stats_step, tile_size, *,
    stack, compose, device, timed_log=None,
) -> RenderOutcome:
    """Shared render epilogue: items grid (unassigned -> black), stats,
    optional composite. `rows`, `dists` are host int32 arrays.
    `stats_step` carries the reference's coordinate quirk (source pixels
    for matched modes, output pixels for global no-repeat); `timed_log`
    adds the no-repeat path's compose timing line."""
    num_tiles = len(tile_set)
    with span("render.stats"):
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
        with span("render.compose") as composing:
            if stack is None:
                stack = tile_set.image_stack(tile_size)
            image = compose_mosaic(items_grid, stack, device=device)
        if timed_log is not None:
            timed_log(f"   compose: {composing.s:.2f}s")
    return RenderOutcome(
        image=image, stats=stats, tile_set=tile_set, items=items_grid
    )


def match_blocks(
    blocks: torch.Tensor,
    lib: torch.Tensor,
    *,
    use_lut: str = "auto",
    metric: str = "l1",
    hybrid: bool = False,
    mesh=None,
    stats: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Match on the blocks' device: the squared-L2 argmin (`metric="l2"`),
    the hybrid (`hybrid=True`, modes above 1), or the exact L1 match: the
    LUT (mode 1, >= 4096 blocks, or `use_lut="always"`), else the argmin
    kernel, with repeated blocks deduplicated first when a sample says
    fewer than half are unique.

    With `mesh` (`parallel.make_mesh`), the exact-L1 match shards blocks
    over "data" and the library over "model" (`sharded_l1_argmin`),
    bit-identical to the single-device kernels; the l2 and hybrid modes,
    an automatic mode-1 LUT and an explicit `use_lut="always"` stay
    single-device, as in the JAX package. Returns host (dist [B] int32,
    row [B] int32).

    `stats` (a dict) gets the match's record: `route` ("lut", "argmin",
    "argmin_dedup", "l2", "hybrid" or "mesh"), `blocks` B, `scored` (the
    rows the argmin scored, the distinct ones after the dedup), `rows` L,
    `width` D, and from `l1_argmin` K1's launch shape `k1` where K1 runs."""
    b, d = blocks.shape
    stats = {} if stats is None else stats
    stats.update(blocks=b, scored=b, rows=lib.shape[0], width=d)
    if metric == "l2":
        stats["route"] = "l2"
        return l2_argmin(blocks, lib)
    if hybrid and d > 3:
        stats["route"] = "hybrid"
        return l1_argmin_hybrid(blocks, lib)
    lut_ok = d == 3 and lib.shape[0] <= MAX_ROWS
    lut_auto = use_lut == "auto" and lut_ok and b >= _LUT_MIN_BLOCKS
    if mesh is not None and use_lut != "always" and not lut_auto:
        # mode-1 runs keep the LUT under a mesh (the same result, faster)
        from emosaic_tpu_torch.parallel import sharded_l1_argmin

        stats["route"] = "mesh"
        return sharded_l1_argmin(blocks, lib, mesh)
    if use_lut == "always" or lut_auto:
        if not lut_ok:
            raise ValueError("LUT path requires mode 1 and a small-enough library")
        stats["route"] = "lut"
        lut = build_l1_lut(lib, device=blocks.device)
        dist, row = lut_match(blocks, lut)
        return copies.to_host(dist), copies.to_host(row)
    # Dedup identical query blocks before the dense kernel (sources repeat
    # colours heavily). Sample first: a full unique over 16M rows isn't free.
    if b > 8192:
        sample = blocks[:: max(1, b // 4096)]
        est = len(torch.unique(sample, dim=0)) / len(sample)
        if est < 0.5:
            uniq, inverse = torch.unique(blocks, dim=0, return_inverse=True)
            stats.update(route="argmin_dedup", scored=uniq.shape[0])
            du, ru = l1_argmin(uniq, lib, stats=stats)
            return copies.to_host(du[inverse]), copies.to_host(ru[inverse])
    stats["route"] = "argmin"
    dist, row = l1_argmin(blocks, lib, stats=stats)
    return copies.to_host(dist), copies.to_host(row)


def render_nto1(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    no_repeat: bool = False,
    randomize: float | None = None,
    *,
    device,
    seed: int = 0,
    use_lut: str = "auto",
    metric: str = "l1",
    hybrid: bool = False,
    stack: np.ndarray | None = None,
    compose: bool = True,
    mesh=None,
    log=lambda *a: print(*a, file=sys.stderr),
) -> RenderOutcome:
    """Render the matched mosaic of `source_img` on `device`: the match of
    `match_blocks`, or with `randomize` a seeded choice among the
    near-best, or with `no_repeat` the in-render no-repeat choice. With
    `mesh`, the match and the top-k lists are sharded over it, with the
    same results.

    The outcome's `info` holds the render's stage spans (`monitor.span`);
    the match of `match_blocks` records itself under `match` (its `stats`);
    with `no_repeat`, also the spans `sequence.scoring` (the top-k lists),
    `sequence.to_host` and `sequence.engine` under `render.match`, and the
    engine's counters (`native.STATS`): its host masked scans
    (`refill_host_events`), their seconds (`refill_host_s`), the candidate
    entries it read (`engine_entries`) and, from the native engine, its own
    seconds (`engine_loop_s`)."""
    if no_repeat and randomize is not None:
        raise ValueError(
            "no_repeat + randomize is unsupported (the reference deadlocks "
            "on this combination, rendering.rs:163-174)"
        )
    if len(tile_set) == 0:
        # the reference panics deep in the kd-tree here; fail clearly
        raise ValueError("❌ No tiles available for matching")
    info = {}
    with record(info):
        dim, htiles, vtiles, blocks, lib = start_render(
            source_img, tile_set, tile_size, log, device=device, check_tiles=no_repeat
        )
        if no_repeat or randomize is not None:
            # these branches always score with the exact L1 top-k: the
            # match-path-only knobs would otherwise be dropped silently
            ignored = [
                name
                for name, off in (
                    (f"--matcher {use_lut}", use_lut == "auto"),
                    (f"--metric {metric}", metric == "l1"),
                    ("--matcher hybrid", not hybrid),
                )
                if not off
            ]
            if ignored:
                log(
                    f"⚠️  {', '.join(ignored)} ignored: "
                    f"{'randomize' if randomize is not None else 'greedy no-repeat'} "
                    "always scores with the exact L1 top-k"
                )
        rng = np.random.default_rng(seed)

        def topk(k: int) -> tuple[np.ndarray, np.ndarray]:
            """Exact top-k candidate lists, sharded over the mesh when given."""
            if mesh is not None:
                from emosaic_tpu_torch.parallel import sharded_l1_topk

                return sharded_l1_topk(blocks, lib, k, mesh)
            return l1_topk(blocks, lib, k)

        with span("render.match"):
            if randomize is not None:
                k = min(_DEFAULT_RANDOM_NEIGHBORS, lib.shape[0])
                cd, cr = topk(k)
                mins = cd[:, 0].astype(np.float64)
                eligible = (cd.astype(np.float64) - mins[:, None]) < (
                    float(randomize) * mins[:, None] / 100.0
                )
                eligible[:, 0] = True  # deviation: avoid the reference's min==0 panic
                counts = eligible.sum(axis=1)
                pick = (rng.random(len(blocks)) * counts).astype(np.int64)
                rows = np.take_along_axis(cr, pick[:, None], axis=1)[:, 0]
                dists = np.take_along_axis(cd, pick[:, None], axis=1)[:, 0]
            elif no_repeat:
                k = min(_GREEDY_TOPK, lib.shape[0])
                with span("sequence.scoring"):
                    cd, cr = topk(k)
                # render order: rows in sequence, x shuffled per row
                order = np.concatenate(
                    [by * htiles + rng.permutation(htiles) for by in range(vtiles)]
                )
                from emosaic_tpu_torch import native

                with span("sequence.to_host"):
                    blocks_h, lib_h = copies.to_host(blocks), copies.to_host(lib)
                with span("sequence.engine"):
                    if native.available():
                        rows, dists = native.greedy_sequence(
                            order, cd, cr, blocks_h, lib_h, stats=info
                        )
                    else:
                        refill = make_numpy_refill(blocks_h, lib_h)
                        rows, dists = greedy_sequence_assign(
                            order, cd, cr, lib.shape[0], refill, stats=info
                        )
            else:
                info["match"] = {}
                dists, rows = match_blocks(
                    blocks, lib, use_lut=use_lut, metric=metric, hybrid=hybrid, mesh=mesh,
                    stats=info["match"],
                )
        # stats_step=dim: source-pixel coords (rendering.rs:211-214)
        out = finish_render(
            rows, dists, vtiles, htiles, tile_set, dim, tile_size,
            stack=stack, compose=compose, device=device,
        )
    out.info = info
    return out
