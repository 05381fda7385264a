"""Global-greedy no-repeat renderer (reference: rendering.rs:262-401).

The torch counterpart of `emosaic_tpu/render/norepeat.py`. Two phases:
1. Scoring: the reference fetches 100 000 NN per block (rendering.rs:
   307-321), which under its 32 767-tile cap is the full sorted list. Here
   the device scorers produce the lists in one batch: the full sorted list
   while B * L is affordable (`exact-full`: K10's dense matrix, each row
   sorted on the card by kernel K13), else an exact 512-entry prefix
   from the adaptive certified scorer (`adaptive-exact`, whose shortlist
   rescore is kernel K3) with exact masked refills during assignment.
   `scorer="hybrid"` takes the approximate L2-prefilter lists (`hybrid`,
   exact L1 distances rescored on K3) past the full-list budget. With a
   mesh, the exact lists come from the adaptive scorer with blocks split
   over every mesh position (`sharded-exact`); an explicit hybrid keeps
   its precedence over the mesh.
2. Assignment: best-match-first priority queue with mirror-pair exclusion
   (render/greedy.py, or the native engine), exactly the worklist
   semantics of rendering.rs:323-392.

Stats record *output-pixel* coordinates (rendering.rs:357-364), unlike
`render_nto1` (a quirk kept from the reference).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from emosaic_tpu_torch.monitor import record, span
from emosaic_tpu_torch.ops import distance as _distance
from emosaic_tpu_torch.ops.distance import (
    l1_block,
    l1_topk_adaptive,
    l1_topk_hybrid,
    sorted_lists,
)
from emosaic_tpu_torch.ops.refill import refiller_for
from emosaic_tpu_torch.render.greedy import greedy_global_assign, make_numpy_refill
from emosaic_tpu_torch.render.matched import (
    RenderOutcome,
    finish_render,
    start_render,
)
from emosaic_tpu_torch.tiles.tileset import TileSet

#: full-list (exact) mode is used while B * L stays under this many entries
_EXACT_BUDGET = 2 * 10**8
#: exact candidates per block past _EXACT_BUDGET. Truncation does not
#: change assignment results: the greedy engines refill exactly whenever a
#: block exhausts its prefix, so K only trades scoring time against refill
#: frequency.
_TRUNCATED_K = 512


def render_nto1_no_repeat(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    *,
    device,
    stack: np.ndarray | None = None,
    compose: bool = True,
    scorer: str = "exact",
    mesh=None,
    log=lambda *a: print(*a, file=sys.stderr),
) -> RenderOutcome:
    """Render the global-greedy no-repeat mosaic on `device`.

    The outcome's `info` holds the scorer used and its statistics (route,
    certified and fallback rows; the exact-full route's pairs, matrix
    bytes, its sort, `k13` on the card or `plain`, and the sort's key
    bytes), the assignment engine with its refill counters and the
    candidate entries the native engine read (`engine_entries`), the
    seconds of scoring and assignment, and the render's
    stage spans (`monitor.span`). `mesh` (`parallel.make_mesh`) shards the
    exact scoring over it."""
    if scorer not in ("exact", "hybrid"):
        # fail loud: a typo would otherwise silently run the exact path
        raise ValueError(f"scorer must be 'exact' or 'hybrid', got {scorer!r}")
    info = {}
    with record(info):
        dim, htiles, vtiles, blocks, lib = start_render(
            source_img, tile_set, tile_size, log, device=device, check_tiles=True
        )
        num_tiles = len(tile_set)
        b, l = blocks.shape[0], lib.shape[0]

        with span("norepeat.scoring") as scoring:
            if scorer == "hybrid" and b * l > _EXACT_BUDGET:
                # the L2 prefilter + exact-L1 rescore: an approximate candidate
                # set with exact distances; assignment still refills exactly, so
                # only the set's membership is approximate
                scorer_used = "hybrid"
                k = min(_TRUNCATED_K, l)
                cd, cr = l1_topk_hybrid(blocks, lib, k, k_pre=min(2 * k, l))
            elif mesh is not None:
                # the adaptive certified scorer with blocks over every mesh
                # position; declined shapes and concentrated data go inside to the
                # sharded stripes. Truncation to K does not change the assignment
                # (see _TRUNCATED_K)
                from emosaic_tpu_torch.parallel import sharded_l1_topk_adaptive

                scorer_used = "sharded-exact"
                k = min(_TRUNCATED_K, l)
                info["scoring"] = {}
                cd, cr = sharded_l1_topk_adaptive(blocks, lib, k, mesh, stats=info["scoring"])
            elif b * l <= _EXACT_BUDGET and lib.numel() <= _distance.DEVICE_LIB_BYTES_MAX:
                # the full sorted candidate list per block: K10's dense matrix
                # stays on the device (4 * B * L bytes, inside `l1_block`'s stripe
                # budget) and K13 sorts every row there on packed (distance, row)
                # keys; only the sorted lists come to the host. Rows are sorted in
                # full: where every tile is used, a fifth of the blocks read past
                # their 1024th entry, so a prefix would send them back to refill
                scorer_used = "exact-full"
                info["scoring"] = {"route": "exact-full", "pairs": b * l,
                                   "matrix_bytes": 4 * b * l}
                with span("scoring.dense"):  # K10's stripes, the matrix left on the card
                    dist = l1_block(blocks, lib)
                with span("scoring.sort"):  # K13, the lists' copy to the host, the split
                    cd, cr = sorted_lists(dist, 255 * blocks.shape[1], stats=info["scoring"])
                del dist
            else:
                # exact truncated lists from the adaptive certified scorer;
                # concentrated data routes inside to the two-level scorer, with
                # identical results
                scorer_used = "adaptive-exact"
                k = min(_TRUNCATED_K, l)
                info["scoring"] = {}
                cd, cr = l1_topk_adaptive(blocks, lib, k, stats=info["scoring"])
        info["scorer"] = scorer_used
        info["scoring_s"] = scoring.s
        log(f"   scoring ({scorer_used}): {info['scoring_s']:.2f}s")
        from emosaic_tpu_torch import native

        with span("norepeat.to_host") as to_host:
            blocks_h = blocks.cpu().numpy()
            lib_h = lib.cpu().numpy()
        with span("norepeat.engine") as engine:
            if native.available():
                refiller = refiller_for(blocks, lib)
                rows, dists = native.greedy_global(
                    cd, cr, blocks_h, lib_h, num_tiles,
                    refill_cb=refiller,
                    cb_max_batch=refiller.max_batch if refiller else 4096,
                    stats=info,
                )
                info["engine"] = "native"
                info["refill_events"] = refiller.n_calls if refiller else 0
                info["refill_blocks"] = refiller.n_blocks if refiller else 0
                info["refill_rows"] = refiller.n_rows if refiller else 0
                info["refill_fused_events"] = refiller.n_fused if refiller else 0
                if refiller is not None and refiller.n_calls:
                    log(f"   device refill events: {refiller.n_calls} ({refiller.n_fused} on K12,"
                        f" {100 * refiller.n_fused / refiller.n_calls:.1f}%)")
            else:
                rows, dists = greedy_global_assign(
                    cd, cr, l, num_tiles, _counted(make_numpy_refill(blocks_h, lib_h), info)
                )
                info["engine"] = "python"
        info["assign_s"] = to_host.s + engine.s
        log(f"   assignment: {info['assign_s']:.2f}s")

        # stats_step=tile_size: output-pixel coords (rendering.rs:357-364)
        out = finish_render(
            rows, dists, vtiles, htiles, tile_set, tile_size, tile_size,
            stack=stack, compose=compose, device=device, timed_log=log,
        )
        _distance._sync(torch.device(device))
    out.info = info
    return out


def _counted(refill, info: dict):
    """`refill` counting its calls and seconds into `info` as the native
    engine counts its host masked scans (`refill_host_events`,
    `refill_host_s`)."""
    info.update(refill_host_events=0, refill_host_s=0.0)

    def counted(block_ids, used):
        t0 = time.perf_counter()
        out = refill(block_ids, used)
        info["refill_host_events"] += 1
        info["refill_host_s"] += time.perf_counter() - t0
        return out

    return counted
