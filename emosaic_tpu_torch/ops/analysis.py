"""Palette analysis: batched box-mean colour reduction, and source blocks.

The torch counterpart of `emosaic_tpu/ops/analysis.py`. Semantics kept:
- a sqrt(N) x sqrt(N) grid of floor(w/dim) x floor(h/dim) boxes; trailing
  pixels beyond dim*bw / dim*bh are dropped (analysis.rs:6-14);
- int32 box sums and a truncating integer mean (color.rs:37-39);
- row-major cell order, and y-major source blocks whose pixels are
  row-major and RGB-interleaved (analysis.rs:23-36, tile.rs:104-120).
"""

from __future__ import annotations

import numpy as np
import torch

from emosaic_tpu_torch.ops.copies import to_device_u8


def analyse_batch(tiles, dim: int, *, device) -> torch.Tensor:
    """Analyse a stack of tiles [T, h, w, 3] uint8 into per-cell average
    colours [T, N, 3] uint8 (cells row-major) on `device`."""
    tiles = to_device_u8(tiles, device)
    if tiles.dim() != 4 or tiles.shape[-1] != 3:
        raise ValueError(f"expected [T,h,w,3], got {tuple(tiles.shape)}")
    t, h, w = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    bh, bw = h // dim, w // dim
    if bh == 0 or bw == 0:
        raise ValueError(f"tile {h}x{w} smaller than {dim}x{dim} grid")
    if bh * bw > (2**31 - 1) // 255:
        raise ValueError(
            f"box {bh}x{bw} too large: per-channel sums exceed "
            "int32 (max ~8.4M pixels per box)"
        )
    x = tiles[:, : dim * bh, : dim * bw, :].to(torch.int32)
    sums = x.reshape(t, dim, bh, dim, bw, 3).sum(dim=(2, 4), dtype=torch.int32)
    means = torch.div(sums, bh * bw, rounding_mode="trunc")
    return means.to(torch.uint8).reshape(t, dim * dim, 3)


def analyse_one(tile, dim: int, *, device) -> np.ndarray:
    """Analyse a single [h, w, 3] image (reference `analyse`, analysis.rs:5)."""
    tile = np.asarray(tile, dtype=np.uint8)
    return analyse_batch(tile[None], dim, device=device)[0].cpu().numpy()


def source_blocks(img, dim: int, *, device) -> torch.Tensor:
    """Split a source image [H, W, 3] uint8 (H, W divisible by `dim`) into
    flattened per-block colour vectors [nby*nbx, 3N] uint8 on `device`."""
    img = to_device_u8(img, device)
    if img.dim() != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3], got {tuple(img.shape)}")
    h, w = img.shape[0], img.shape[1]
    if h % dim or w % dim:
        raise ValueError(f"dims {(h, w)} not divisible by {dim}")
    nby, nbx = h // dim, w // dim
    x = img.reshape(nby, dim, nbx, dim, 3).permute(0, 2, 1, 3, 4)
    return x.reshape(nby * nbx, dim * dim * 3).contiguous()
