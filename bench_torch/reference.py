"""The plain reference of a render: the signed item grid and the composed
image, in plain PyTorch, independent of the program (it imports nothing of
`emosaic_tpu_torch` and takes nothing the program made).

The pieces of the semantics, from the reference emosaic
(pepeiborra/emosaic) as the port states them; a configuration names the
whole (`semantics/<name>.py`), which puts them together:
- a source block is the dim x dim pixels of the photo, row-major, RGB
  interleaved, blocks y-major; a library row is a palette (its cell grid
  row-major) or its horizontal mirror, rows [0, T) the tiles and [T, 2T)
  their mirrors;
- distances are exact L1 over the bytes;
- the repeat render takes each block's nearest row, the lowest row among
  equal distances;
- the no-repeat render is the global greedy: (block, row) pairs in
  ascending (distance, block, row) order, a pair taken when its block is
  free and neither the row's tile nor its mirror is used yet;
- item = row + 1 for a tile, -(row - T + 1) for a mirror; the image places
  each item's tile (mirrored for a negative item) at its block.

`bits` < 8 cuts every byte to its top `bits` bits before the distances:
the control, a lower precision in the program's place, which has to come
out as not correct.
"""

from __future__ import annotations

import torch

#: query rows per distance chunk (a [rows, L] slab)
_CHUNK_ELEMS = 1 << 29
#: rows at most this wide take the thermometer product, wider ones cdist
_THERMO_MAX_D = 256
#: coordinates a thermometer product sums: 8 x 255 levels = 2040 terms of 0
#: or 1, an integer below 2048 and so exact in f16 whatever the order
_THERMO_COORDS = 8


def blocks_of(img: torch.Tensor, dim: int) -> torch.Tensor:
    """[H, W, 3] u8 -> [B, dim*dim*3] u8, blocks y-major."""
    h, w = img.shape[0] // dim, img.shape[1] // dim
    x = img[: h * dim, : w * dim].reshape(h, dim, w, dim, 3).permute(0, 2, 1, 3, 4)
    return x.reshape(h * w, dim * dim * 3)


def library_rows(pal: torch.Tensor) -> torch.Tensor:
    """[T, N, 3] palettes -> [2T, 3N] rows: the palettes, then their mirrors."""
    t, n = pal.shape[0], pal.shape[1]
    dim = int(round(n ** 0.5))
    mirror = pal.reshape(t, dim, dim, 3).flip(2).reshape(t, n, 3)
    return torch.cat([pal.reshape(t, -1), mirror.reshape(t, -1)])


def _levels(x: torch.Tensor, bits: int) -> torch.Tensor:
    return x >> (8 - bits) if bits < 8 else x


def _thermo(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[n, d] u8 -> [n, d * (2^bits - 1)] f16 of [x >= k], k = 1..2^bits - 1."""
    k = torch.arange((1 << bits) - 1, device=x.device, dtype=torch.uint8)
    return (x[:, :, None] > k).reshape(x.shape[0], -1).to(torch.float16)


def _thermo_chunks(x: torch.Tensor, bits: int):
    step = _THERMO_COORDS
    return [_thermo(x[:, c : c + step], bits) for c in range(0, x.shape[1], step)]


def distances(x: torch.Tensor, lib: torch.Tensor, bits: int = 8):
    """Yield (r0, int32 [rows, L] exact L1 distances) over chunks of x.

    Narrow rows: |a - b| = a + b - 2 min(a, b), and min(a, b) is the dot of
    the two thermometer codes ([a >= k] . [b >= k] over the levels k), a
    f16 product of 0s and 1s, exact in blocks of 8 coordinates. Wide rows:
    `torch.cdist(p=1)` in f32, exact while a sum stays under 2^24."""
    x, lib = _levels(x, bits), _levels(lib, bits)
    d = x.shape[1]
    step = max(1, _CHUNK_ELEMS // max(1, lib.shape[0]))
    if d <= _THERMO_MAX_D:
        tcodes = _thermo_chunks(lib, bits)
        tsum = lib.to(torch.int32).sum(1, dtype=torch.int32)
        for r0 in range(0, x.shape[0], step):
            xs = x[r0 : r0 + step]
            mins = torch.zeros((xs.shape[0], lib.shape[0]), dtype=torch.int32,
                               device=x.device)
            for xc, tc in zip(_thermo_chunks(xs, bits), tcodes):
                mins += (xc @ tc.T).to(torch.int32)
            xsum = xs.to(torch.int32).sum(1, dtype=torch.int32)
            yield r0, xsum[:, None] + tsum[None, :] - 2 * mins
        return
    if d * 255 >= 1 << 24:
        raise ValueError("rows too wide for exact f32 sums")
    t = lib.to(torch.float32)
    for r0 in range(0, x.shape[0], step):
        dist = torch.cdist(x[r0 : r0 + step].to(torch.float32), t, p=1)
        yield r0, dist.round_().to(torch.int32)


def nearest(x: torch.Tensor, lib: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """[B] int64: each block's nearest row, the lowest among equal distances."""
    l = lib.shape[0]
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    cols = torch.arange(l, device=x.device)
    for r0, d in distances(x, lib, bits):
        key = d.to(torch.int64) * l + cols
        out[r0 : r0 + d.shape[0]] = key.amin(dim=1) % l
    return out


def greedy(x: torch.Tensor, lib: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """[B] int64 rows of the global greedy no-repeat assignment (-1: none).

    A tile's two rows share one key per block: the nearer row, the lower on
    a tie, since whichever of a (block, tile)'s two pairs comes first in
    (distance, block, row) order settles that block or that tile. Each
    round takes every (block, tile) pair that is the least among the free
    pairs of its block and of its tile; the sequential greedy takes exactly
    these pairs (no earlier pair can claim either side), so rounds until no
    block or no tile is free give its result."""
    b, l = x.shape[0], lib.shape[0]
    t = l // 2
    # bkey orders a block's pairs: distance, then row; tkey a tile's:
    # distance, then block
    bkey = torch.empty((b, t), dtype=torch.int64, device=x.device)
    tkey = torch.empty((b, t), dtype=torch.int64, device=x.device)
    tiles = torch.arange(t, device=x.device)
    for r0, d in distances(x, lib, bits):
        n = d.shape[0]
        near = torch.minimum(d[:, :t], d[:, t:]).to(torch.int64)
        row = tiles + (d[:, t:] < d[:, :t]).to(torch.int64) * t
        bkey[r0 : r0 + n] = near * l + row
        tkey[r0 : r0 + n] = near * b + torch.arange(r0, r0 + n, device=x.device)[:, None]
        del d, near, row
    big = torch.iinfo(torch.int64).max
    out = torch.full((b,), -1, dtype=torch.int64, device=x.device)
    free_b = torch.arange(b, device=x.device)
    tile_used = torch.zeros(t, dtype=torch.bool, device=x.device)
    while free_b.numel() and not bool(tile_used.all()):
        best_t = bkey.argmin(dim=1)
        best_b = tkey.argmin(dim=0)
        pos = torch.arange(free_b.numel(), device=x.device)
        take = best_b[best_t] == pos
        tl = best_t[take]
        out[free_b[take]] = bkey[take, tl] % l
        tile_used[tl] = True
        bkey[:, tl] = big
        tkey[:, tl] = big
        keep = ~take
        free_b, bkey, tkey = free_b[keep], bkey[keep], tkey[keep]
    return out


def items_of(rows: torch.Tensor, t: int) -> torch.Tensor:
    """Library rows -> signed 1-based items, int32 (-1 rows -> 0, black)."""
    it = torch.where(rows < t, rows + 1, -(rows - t + 1))
    return torch.where(rows < 0, torch.zeros_like(it), it).to(torch.int32)


def compose(items: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """[nby, nbx] items, [T, ts, ts, 3] tiles -> [nby*ts, nbx*ts, 3] u8."""
    nby, nbx = items.shape
    ts = stack.shape[1]
    flat = items.reshape(-1).to(torch.int64)
    tiles = stack.index_select(0, (flat.abs() - 1).clamp(min=0))
    tiles = torch.where((flat < 0)[:, None, None, None], tiles.flip(2), tiles)
    tiles = tiles * (flat != 0)[:, None, None, None].to(torch.uint8)
    return tiles.reshape(nby, nbx, ts, ts, 3).permute(0, 2, 1, 3, 4).reshape(
        nby * ts, nbx * ts, 3)


def render(src: torch.Tensor, pal: torch.Tensor, stack: torch.Tensor, dim: int,
           assign, bits: int = 8):
    """(items [nby, nbx] int32, image u8) of one render, on src's device;
    `assign(blocks, rows, bits)` gives each block's library row (`nearest`,
    `greedy`)."""
    lib = library_rows(pal.to(src.device))
    x = blocks_of(src, dim)
    rows = assign(x, lib, bits)
    del x, lib
    items = items_of(rows, pal.shape[0]).reshape(src.shape[0] // dim, src.shape[1] // dim)
    return items, compose(items, stack.to(src.device))
