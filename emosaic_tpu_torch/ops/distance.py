"""Exact L1 (Manhattan) nearest-row matching: library build and argmin.

The torch counterpart of the argmin slice of `emosaic_tpu/ops/distance.py`.

- `build_library`: the [2T, 3N] library with horizontally-flipped
  duplicates of every tile: row r < T is item r+1, row r >= T is item
  -(r-T+1) (tileset.rs:180-188).
- `l1_argmin`: the exact nearest row per block. On a CUDA tensor it
  launches the hand-written kernel `csrc/l1_argmin.cu`; on a CPU tensor it
  runs `l1_argmin_ref`, its plain torch version.

Distances are exact int32, ties go to the lowest library row.
"""

from __future__ import annotations

import ctypes
import math

import torch

from emosaic_tpu_torch.ops._kernels import L1_ARGMIN

I32_MAX = 2**31 - 1

#: device-resident library budget (u8 bytes of [L, D]); the JAX package
#: streams larger libraries in host banks, which this port does not yet do
DEVICE_LIB_BYTES_MAX = 16 << 30

#: K1 blocks per SM that fill the card; with fewer query tiles than
#: SMs x this, K1 splits the library across blocks
_BLOCKS_PER_SM = 8


def flip_palettes(palettes: torch.Tensor) -> torch.Tensor:
    """Horizontally mirror each palette's cell grid (utils.rs:18-43)."""
    t, n = palettes.shape[0], palettes.shape[1]
    dim = math.isqrt(n)
    if dim * dim != n:
        raise ValueError(f"N={n} is not a perfect square")
    return palettes.reshape(t, dim, dim, 3).flip(2).reshape(t, n, 3)


def build_library(palettes: torch.Tensor) -> torch.Tensor:
    """Stack palettes [T, N, 3] u8 and their flips into a [2T, 3N] u8 matrix
    on the palettes' device."""
    t = palettes.shape[0]
    flat = palettes.reshape(t, -1)
    flipped = flip_palettes(palettes).reshape(t, -1)
    return torch.cat([flat, flipped], dim=0).contiguous()


def rows_to_items(rows: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Library row -> signed 1-based item id (negative = flipped)."""
    return torch.where(
        rows < num_tiles, rows + 1, -(rows - num_tiles + 1)
    ).to(torch.int32)


def items_to_rows(items: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Signed item id -> library row."""
    return torch.where(items > 0, items - 1, num_tiles - items - 1).to(
        torch.int32
    )


def _chunk_sizes(d: int, budget: int = 64 * 2**20) -> tuple[int, int]:
    """(block_chunk, lib_chunk) so the [bc, lc, D] int32 diff fits `budget`."""
    bc = 1024
    lc = max(256, min(8192, budget // max(1, bc * d * 4)))
    while bc > 64 and bc * lc * d * 4 > budget:
        bc //= 2
    return bc, lc


def l1_argmin_ref(
    blocks: torch.Tensor, lib: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1: chunked int32 abs-diff sums, first-minimum
    argmin per chunk, and a strictly-less fold over ascending chunks, so the
    lowest row wins ties. Returns (dist [B] i32, row [B] i32)."""
    b, d = blocks.shape
    l = lib.shape[0]
    bc, lc = _chunk_sizes(d)
    dist = torch.full((b,), I32_MAX, dtype=torch.int32, device=blocks.device)
    row = torch.zeros((b,), dtype=torch.int32, device=blocks.device)
    for b0 in range(0, b, bc):
        # cast before subtracting: u8 arithmetic wraps
        x = blocks[b0 : b0 + bc].to(torch.int32)
        best_d = dist[b0 : b0 + bc]
        best_r = row[b0 : b0 + bc]
        for l0 in range(0, l, lc):
            y = lib[l0 : l0 + lc].to(torch.int32)
            dd = (x[:, None, :] - y[None, :, :]).abs().sum(-1, dtype=torch.int32)
            local_r = dd.argmin(dim=1)  # the first minimum (pinned by a test)
            local_d = dd.gather(1, local_r[:, None])[:, 0]
            take = local_d < best_d
            best_d.copy_(torch.where(take, local_d, best_d))
            best_r.copy_(torch.where(take, local_r.to(torch.int32) + l0, best_r))
    return dist, row


def _pad_words(x: torch.Tensor, d4: int) -> torch.Tensor:
    """Zero-pad the feature axis to d4 bytes (a multiple of 4) and make the
    rows 4-byte aligned, as `__vsadu4` reads whole words."""
    if x.shape[1] != d4:
        x = torch.nn.functional.pad(x, (0, d4 - x.shape[1]))
    x = x.contiguous()
    if x.data_ptr() % 4:
        x = x.clone()
    return x


def _l1_argmin_cuda(
    blocks: torch.Tensor, lib: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    b, d = blocks.shape
    l = lib.shape[0]
    d4 = -(-d // 4) * 4
    q = _pad_words(blocks, d4)
    t = _pad_words(lib, d4)
    keys = torch.empty((b,), dtype=torch.int64, device=blocks.device)
    dist = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    row = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    if b == 0:
        return dist, row
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    sms = torch.cuda.get_device_properties(blocks.device).multi_processor_count
    L1_ARGMIN.launch(
        blocks.device.index,
        ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_void_p(dist.data_ptr()),
        ctypes.c_void_p(row.data_ptr()),
        b,
        l,
        d4 // 4,
        sms * _BLOCKS_PER_SM,
        ctypes.c_void_p(stream),
    )
    return dist, row


def l1_argmin(
    blocks: torch.Tensor, lib: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact L1 nearest library row per block.

    Args:
      blocks: [B, D] uint8 query vectors.
      lib: [L, D] uint8 library matrix (see `build_library`), L >= 1, on the
        same device.

    Returns:
      (dist [B] int32, row [B] int32) on that device: the least L1 distance
      and the lowest library row reaching it.

    A CUDA tensor goes to K1 (`csrc/l1_argmin.cu`) for every D the modes
    produce; a CPU tensor to `l1_argmin_ref`.
    """
    if blocks.dtype != torch.uint8 or lib.dtype != torch.uint8:
        raise TypeError(f"l1_argmin takes uint8, got {blocks.dtype}/{lib.dtype}")
    if blocks.dim() != 2 or lib.dim() != 2 or blocks.shape[1] != lib.shape[1]:
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(lib.shape)}")
    if blocks.device != lib.device:
        raise ValueError(f"devices differ: {blocks.device} / {lib.device}")
    b, l = blocks.shape[0], lib.shape[0]
    if l == 0:
        raise ValueError("empty library")
    if lib.numel() > DEVICE_LIB_BYTES_MAX:
        raise NotImplementedError(
            f"library of {lib.numel()} bytes exceeds the device-resident "
            f"budget ({DEVICE_LIB_BYTES_MAX}); streamed host banks are "
            "ROADMAP item 'ops/distance.py slice C'"
        )
    if b >= 2**31 or l >= 2**31:
        raise ValueError(f"B={b} or L={l} does not fit int32 indices")
    if blocks.device.type == "cpu":
        return l1_argmin_ref(blocks, lib)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    return _l1_argmin_cuda(blocks, lib)
