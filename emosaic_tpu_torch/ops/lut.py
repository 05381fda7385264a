"""Exact L1 nearest-row lookup table over the 256^3 RGB lattice (mode 1).

The torch counterpart of `emosaic_tpu/ops/lut.py`. For every colour the
table holds the nearest library row under L1, built with an exact
separable min-plus (chamfer) distance transform: log-doubling relaxation
passes (steps 1, 2, ..., 128 both ways, per axis) over a lattice of packed
int32 keys `(dist << ROW_BITS) | row`, so every `min` is lexicographic on
(distance, row) and ties go to the lowest row, as in `l1_argmin`.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from emosaic_tpu_torch.ops.analysis import to_device_u8

ROW_BITS = 21
ROW_MASK = (1 << ROW_BITS) - 1
#: max library rows (2T) a LUT key can address
MAX_ROWS = ROW_MASK
_INF = 2**31 - 1

# Content-keyed cache of built LUTs (a resident caller re-matches the same
# library every request); keyed by library bytes and device, 64 MB each.
# EMOSAIC_LUT_CACHE=0 disables.
_LUT_CACHE: "dict[tuple[bytes, int, str], torch.Tensor]" = {}
_LUT_CACHE_MAX = 2


def _shifted(lattice: torch.Tensor, axis: int, step: int, forward: bool) -> torch.Tensor:
    """Shift along `axis` by `step`, filling vacated cells with INF."""
    out = torch.full_like(lattice, _INF)
    if forward:
        out.narrow(axis, step, 256 - step).copy_(lattice.narrow(axis, 0, 256 - step))
    else:
        out.narrow(axis, 0, 256 - step).copy_(lattice.narrow(axis, step, 256 - step))
    return out


def _build(lib: np.ndarray, device) -> torch.Tensor:
    # lattice axes are [b, g, r]: flat index b*65536 + g*256 + r (pack_rgb)
    idx = pack_rgb(lib)
    # first occurrence per colour = lowest row (rows ascend): a host dedup
    # followed by a plain index write, exact without a scatter-min
    uniq, first = np.unique(idx, return_index=True)
    lattice = torch.full((256 * 256 * 256,), _INF, dtype=torch.int32, device=device)
    lattice[torch.as_tensor(uniq.astype(np.int64), device=device)] = torch.as_tensor(
        first.astype(np.int32), device=device
    )
    lattice = lattice.reshape(256, 256, 256)
    inf = torch.tensor(_INF, dtype=torch.int32, device=device)
    for axis in range(3):
        step = 1
        while step <= 128:
            delta = step << ROW_BITS
            fwd = _shifted(lattice, axis, step, True)
            bwd = _shifted(lattice, axis, step, False)
            # guard the INF sentinel: int32 addition would wrap silently
            fwd = torch.where(fwd == _INF, inf, fwd + delta)
            bwd = torch.where(bwd == _INF, inf, bwd + delta)
            lattice = torch.minimum(lattice, torch.minimum(fwd, bwd))
            step *= 2
    return lattice


def build_l1_lut(lib, *, device) -> torch.Tensor:
    """Build the [256, 256, 256] int32 packed (dist, row) nearest-row table
    on `device` from a [L, 3] uint8 mode-1 library (host array or tensor).
    Results are cached per library content and device."""
    if isinstance(lib, torch.Tensor):
        lib = lib.cpu().numpy()
    lib = np.ascontiguousarray(lib, dtype=np.uint8)
    if lib.ndim != 2 or lib.shape[1] != 3:
        raise ValueError(f"LUT requires [L,3] mode-1 library, got {lib.shape}")
    if lib.shape[0] == 0:
        raise ValueError("empty library")
    if lib.shape[0] > MAX_ROWS:
        raise ValueError(f"library has {lib.shape[0]} rows > LUT cap {MAX_ROWS}")
    device = torch.device(device)
    use_cache = os.environ.get("EMOSAIC_LUT_CACHE", "1") != "0"
    if use_cache:
        key = (hashlib.md5(lib.tobytes()).digest(), lib.shape[0], str(device))
        hit = _LUT_CACHE.get(key)
        if hit is not None:
            return hit
    lut = _build(lib, device)
    if use_cache:
        while len(_LUT_CACHE) >= _LUT_CACHE_MAX:
            _LUT_CACHE.pop(next(iter(_LUT_CACHE)))
        _LUT_CACHE[key] = lut
    return lut


def pack_rgb(blocks):
    """Pack [B, 3] uint8 RGB into the LUT's flat int32 index
    b*65536 + g*256 + r. A numpy array packs on the host, a tensor on its
    device."""
    if isinstance(blocks, torch.Tensor):
        x = blocks.to(torch.int32)
        return x[:, 2] * 65536 + x[:, 1] * 256 + x[:, 0]
    blocks = np.asarray(blocks, dtype=np.uint8)
    return (
        blocks[:, 2].astype(np.int32) * 65536
        + blocks[:, 1].astype(np.int32) * 256
        + blocks[:, 0].astype(np.int32)
    )


def lut_match_packed(idx: torch.Tensor, lut: torch.Tensor):
    """Match pre-packed flat indices (see `pack_rgb`) on the LUT's device.
    A plain int32 gather: the JAX package's 8-wide row fetch (lut.py:145)
    answers a TPU gather-engine cost, which an H100 does not have."""
    key = lut.reshape(-1)[idx.to(device=lut.device, dtype=torch.int64)]
    return key >> ROW_BITS, key & ROW_MASK


def lut_match(blocks, lut: torch.Tensor):
    """Match [B, 3] uint8 blocks (host array or tensor) via the LUT.
    Returns (dist [B] int32, row [B] int32) on the LUT's device, identical
    to `l1_argmin(blocks, lib)`."""
    blocks = to_device_u8(blocks, lut.device)
    if blocks.dim() != 2 or blocks.shape[1] != 3:
        raise ValueError(f"LUT match requires [B,3] blocks, got {tuple(blocks.shape)}")
    return lut_match_packed(pack_rgb(blocks), lut)
