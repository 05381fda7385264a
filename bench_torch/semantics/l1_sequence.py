"""The in-render no-repeat render (`render_nto1(no_repeat=True)`, upstream's
`--no-repeat --greedy`, rendering.rs:124-230): the blocks in render order,
the rows of the grid in sequence and a seeded shuffle within each row
(rendering.rs:73-74, the generator `np.random.default_rng(seed)` drawn row
by row); each block takes the unused library row at the least exact L1
distance, the lowest among equal distances, and only that row is removed:
its mirror stays (rendering.rs:163-167, :207-209). A block with no row
left is black. The composite of the items."""

import numpy as np
import torch

from bench_torch import reference

#: the distance of a used row: above any exact L1 distance of u8 rows
_USED = torch.iinfo(torch.int32).max


def order(vtiles: int, htiles: int, seed: int) -> np.ndarray:
    """[B] block indices in render order."""
    rng = np.random.default_rng(seed)
    return np.concatenate([by * htiles + rng.permutation(htiles) for by in range(vtiles)])


def sequence(x: torch.Tensor, lib: torch.Tensor, blocks_in_order, bits: int = 8):
    """[B] int64 rows of the in-render assignment (-1: no row left).

    The [B, L] distances are computed in row chunks; then each block in
    turn takes the least entry of its row, `torch.min`'s first minimum,
    so the lowest row among equal distances, and that row's column is set
    to `_USED` for every block."""
    b, l = x.shape[0], lib.shape[0]
    dist = torch.empty((b, l), dtype=torch.int32, device=x.device)
    for r0, d in reference.distances(x, lib, bits):
        dist[r0 : r0 + d.shape[0]] = d
        del d
    rows = torch.empty(b, dtype=torch.int64, device=x.device)
    best = torch.empty(b, dtype=torch.int32, device=x.device)
    for blk in blocks_in_order.tolist():
        v, r = dist[blk].min(0)
        rows[blk], best[blk] = r, v
        dist.index_fill_(1, r.view(1), _USED)
    return torch.where(best == _USED, -1, rows)


def render(src, pal, stack, cfg, bits=8):
    dim = cfg["mode"]
    vtiles, htiles = src.shape[0] // dim, src.shape[1] // dim
    lib = reference.library_rows(pal.to(src.device))
    x = reference.blocks_of(src, dim)
    rows = sequence(x, lib, order(vtiles, htiles, cfg["render"].get("seed", 0)), bits)
    del x, lib
    items = reference.items_of(rows, pal.shape[0]).reshape(vtiles, htiles)
    return items, reference.compose(items, stack.to(src.device))
