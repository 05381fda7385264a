"""Exact L1 (Manhattan) matching: library build, argmin and exact top-k.

The torch counterpart of `emosaic_tpu/ops/distance.py`.

- `build_library`: the [2T, 3N] library with horizontally-flipped
  duplicates of every tile: row r < T is item r+1, row r >= T is item
  -(r-T+1) (tileset.rs:180-188).
- `l1_argmin`: the exact nearest row per block. On a CUDA tensor it
  launches the hand-written kernel K1 `csrc/l1_argmin.cu`; on a CPU tensor
  it runs `l1_argmin_ref`, its plain torch version.
- `l1_topk` and the scorers behind it (`l1_topk_stripes`,
  `l1_topk_twolevel`, `l1_topk_adaptive`, `l1_topk_streamed`): exact k
  nearest rows per block for `--randomize` (rendering.rs:168-185) and the
  no-repeat candidate lists (rendering.rs:307-321). The dense distance
  stripes come from `l1_block`, on the card the hand-written kernel K10
  `csrc/l1_topcap.cu` (its stripe entry; `_l1_block_ref` its plain
  version); the two-level scorer's stage 1 is K10's fused entry
  `l1_topcap` (each 128-row segment's least keys without the stripe;
  `_l1_topcap_ref` its plain version); the adaptive scorer's shortlist rescore is
  the hand-written kernel K3 `csrc/l1_rows.cu` (`l1_rows`), with
  `_l1_rows_ref` its plain version for CPU tensors; its coarse pass
  scores the projected library and keeps each segment's least keys in one
  kernel, K9 `csrc/coarse_topcap.cu` (`coarse_topcap`), with
  `_coarse_topcap_ref` (`l1_block`, then `_seg_topcap_ref`) its plain
  version. K4 `csrc/seg_topcap.cu` (`seg_topcap`, plain version
  `_seg_topcap_ref`) selects from a given stripe (`seg_topk`); K4 and K9
  share one selection routine (`csrc/seg_select.cuh`) with K10.
- `l1_argmin_stripes`, `l1_argmin_xla`: the JAX package's other exact
  argmins under their names (over K10's stripes, and the plain scan).
- `l1_topk_hybrid`, `l1_argmin_hybrid` (`--matcher hybrid`) and
  `l2_argmin` (`--metric l2`): the approximate squared-L2 prefilter with
  an exact-L1 rescore on K3, and the squared-L2 argmin. Both score in
  exact integers on the hand-written kernel K11 `csrc/l2_score.cu`
  (tensor-core u8 products): its argmin entry (`_l2_argmin`, plain
  version `_l2_argmin_ref`) and its fused per-segment top-cap
  (`l2_topcap`, plain version `_l2_topcap_ref`), the prefilter's stage 1.
- `row_sort`, `sorted_lists`, `unpack_lists`: every row of a dense
  distance matrix sorted on the packed (distance, column) key, the
  exact-full no-repeat route's full candidate lists, brought to the host
  as those keys where they fit 4 bytes. On the card it launches the
  hand-written kernel K13 `csrc/row_sort.cu`; on a CPU tensor it runs
  `_row_sort_ref`, its plain torch version.

The no-repeat engine's device refill (K12, `DeviceRefiller`) is
`ops/refill.py`.

Distances are exact int32. Ties go to the lowest library row: every top-k
selection sorts on a packed int64 key (distance << 32) | row, because
`torch.topk` does not put the lowest index first among equal values.

The scorers take uint8 tensors (or numpy arrays) and compute on `device`,
which defaults to the device of `blocks` when it is a tensor and to the
card when it is a host array (`_device_of`); a library may stay on the host
and is then uploaded bank by bank (`l1_topk_streamed`). They return host
numpy arrays, like the JAX package's.

TPU-only devices of the JAX package that this port drops, one line each:

- `_lib_banks` / `_DMA_LIB_BYTES_MAX`: TPU DMA row offsets wrap at 4 GiB;
  K3 uses 64-bit offsets.
- the static-slice + `optimization_barrier` chain of `_ad_proj_bank_jit`:
  it works around an XLA-TPU scan miscompile; the projection here is a
  plain chunked loop.
- the bf16 selection matmul of `_ad_project`: see `_ad_project`.
- the f32-vs-i32 stripe choice (`_stripe_f32_ok`): a v5e lane-rate fact.
- `_rescore_use_dma`: the hybrid rescore's DMA eligibility (a TPU
  addressing limit); K3 takes every library on the card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import math
import os
import sys

import numpy as np
import torch

from emosaic_tpu_torch.monitor import span
from emosaic_tpu_torch.ops.copies import Assembly
from emosaic_tpu_torch.ops.copies import to_host as _host
from emosaic_tpu_torch.ops._kernels import (
    COARSE_TOPCAP,
    L1_ARGMIN,
    L1_ROWS,
    L1_STRIPE,
    L1_TOPCAP,
    L2_ARGMIN,
    L2_TOPCAP,
    ROW_SORT,
    SEG_TOPCAP,
)

I32_MAX = 2**31 - 1
_MASK32 = 0xFFFFFFFF

#: device-resident library budget (u8 bytes of [L, D]). Re-derived for the
#: H100's 80 GB: the adaptive scorer holds the library, its projected
#: f32 copy in segment-major order (at most 1x the library at the smallest
#: group g = 4), the 2 GB survivor lists and a few
#: GB of stripe workspace, and the streamed scorer's prefetch holds two
#: half-budget banks; 16 GB leaves that inside 80 GB. Larger libraries
#: stream in banks (`l1_topk_streamed`). EMOSAIC_DEVICE_LIB_BYTES
#: overrides it, as in the JAX package.
DEVICE_LIB_BYTES_MAX = int(os.environ.get("EMOSAIC_DEVICE_LIB_BYTES", 16 << 30))

#: K1 blocks per SM that fill the card; with fewer query tiles than
#: SMs x this, K1 splits the library across blocks
_BLOCKS_PER_SM = 8
#: K1's tiles (`csrc/l1_argmin.cu`), (queries, library rows): the register
#: path takes rows of at most `_K1_REG_WORDS` 4-byte words, the staged
#: path the rest, padded to whole 16-byte vectors
_K1_REG_WORDS = 16
_K1_REG_TILE = (256, 256)
_K1_STAGED_TILE = (128, 128)
#: K3 blocks per SM that fill the card; with fewer queries than SMs x
#: this, K3's per-query path splits each query's candidates across blocks
_ROWS_BLOCKS_PER_SM = 8
#: K3's grouped path (`csrc/l1_rows.cu`): the shared memory a block may
#: use (227 KB less room for its static arrays), the part its sort and
#: sorted lists take (the kernel's SORT_BYTES), entries per sort, the
#: largest group, and the least row width in 16-byte vectors that takes it
#: (narrower rows take the per-query path)
_K3_SMEM_BYTES = 226 * 1024
_K3_SORT_BYTES = 96 * 1024
_K3_ENTRIES = 16384
_K3_GROUP_MAX = 64
_K3_GROUPED_MIN_VEC = 32
#: buckets of the grouped path's query order (the kernel's NBK)
_K3_BUCKETS = 65536


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


def _as_u8(x) -> torch.Tensor:
    """A uint8 tensor of a tensor or an array, without a copy where the
    array allows it (read-only arrays are copied)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        return x
    a = np.ascontiguousarray(x, dtype=np.uint8)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _device_of(blocks, device) -> torch.device:
    """The device a public scorer runs on: `device` when given, else the
    blocks' own when they are a tensor, else the card (host arrays run on
    `cuda`, and raise where no GPU is visible; `device="cpu"` asks for the
    CPU)."""
    if device is not None:
        return torch.device(device)
    if isinstance(blocks, torch.Tensor):
        return blocks.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no GPU is visible: host arrays run on cuda by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Argmin (K1)
# ---------------------------------------------------------------------------


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


def _pad_words(x: torch.Tensor, width: int, align: int = 4) -> torch.Tensor:
    """Zero-pad the feature axis to `width` bytes (a multiple of `align`)
    and make the rows `align`-byte aligned, as the kernels read whole
    4-byte words (K1) or 16-byte vectors (K3)."""
    if x.shape[1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    x = x.contiguous()
    if x.data_ptr() % align:
        x = x.clone()
    return x


def _k1_plan(b: int, l: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """K1's launch for B queries against L rows of D bytes on `sms` SMs:
    (row width in 4-byte words after padding, query tiles, library splits,
    library tiles per split). Rows of at most `_K1_REG_WORDS` words take
    the register path and pad to whole words; wider rows take the staged
    path and pad to whole 16-byte vectors. The library is split until the
    grid holds SMs x `_BLOCKS_PER_SM` blocks, and every split is non-empty."""
    dw = -(-d // 4)
    reg = dw <= _K1_REG_WORDS
    if not reg:
        dw = -(-dw // 4) * 4
    tq, tl = _K1_REG_TILE if reg else _K1_STAGED_TILE
    qtiles = -(-b // tq)
    ntiles = -(-l // tl)
    nsplit = max(1, min(ntiles, 65535, -(-sms * _BLOCKS_PER_SM // max(1, qtiles))))
    per = -(-ntiles // nsplit)
    return dw, qtiles, -(-ntiles // per), per


def _l1_argmin_cuda(
    blocks: torch.Tensor, lib: torch.Tensor, stats: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    b, d = blocks.shape
    l = lib.shape[0]
    dist = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    row = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    if b == 0:
        return dist, row
    sms = torch.cuda.get_device_properties(blocks.device).multi_processor_count
    dw, _, nsplit, per = _k1_plan(b, l, d, sms)
    if stats is not None:
        stats["k1"] = {"path": "reg" if dw <= _K1_REG_WORDS else "staged",
                       "width_words": dw, "splits": nsplit, "tiles_per_split": per}
    q = _pad_words(blocks, 4 * dw, 16)
    t = _pad_words(lib, 4 * dw, 16)
    keys = torch.empty((b,), dtype=torch.int64, device=blocks.device)
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    L1_ARGMIN.launch(
        blocks.device.index,
        ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_void_p(dist.data_ptr()),
        ctypes.c_void_p(row.data_ptr()),
        b,
        l,
        dw,
        nsplit,
        per,
        ctypes.c_void_p(stream),
    )
    return dist, row


def l1_argmin(
    blocks: torch.Tensor, lib: torch.Tensor, *, stats: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact L1 nearest library row per block.

    Args:
      blocks: [B, D] uint8 query vectors.
      lib: [L, D] uint8 library matrix (see `build_library`), L >= 1, on the
        same device, or on the host when it exceeds `DEVICE_LIB_BYTES_MAX`.

    Returns:
      (dist [B] int32, row [B] int32) on the blocks' device: the least L1
      distance and the lowest library row reaching it.

    A CUDA tensor goes to K1 (`csrc/l1_argmin.cu`) for every D the modes
    produce; a CPU tensor to `l1_argmin_ref`. A library over the device
    budget streams in banks through `l1_topk_streamed` with k = 1, which
    keeps the lowest-row rule through the cross-bank merge. Where K1 runs,
    `stats` (a dict) gets its launch shape under `k1`: `path` ("reg" or
    "staged"), `width_words` (the padded row), `splits` (of the library)
    and `tiles_per_split`, as `_k1_plan` gives them.
    """
    if blocks.dtype != torch.uint8 or lib.dtype != torch.uint8:
        raise TypeError(f"l1_argmin takes uint8, got {blocks.dtype}/{lib.dtype}")
    if blocks.dim() != 2 or lib.dim() != 2 or blocks.shape[1] != lib.shape[1]:
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(lib.shape)}")
    b, l = blocks.shape[0], lib.shape[0]
    if l == 0:
        raise ValueError("empty library")
    if lib.numel() > DEVICE_LIB_BYTES_MAX and l > _TL_SEG:
        da, ra = l1_topk_streamed(blocks, lib, 1)
        dev = blocks.device
        return (
            torch.from_numpy(np.ascontiguousarray(da[:, 0])).to(dev),
            torch.from_numpy(np.ascontiguousarray(ra[:, 0])).to(dev),
        )
    if blocks.device != lib.device:
        raise ValueError(f"devices differ: {blocks.device} / {lib.device}")
    if b >= 2**31 or l >= 2**31:
        raise ValueError(f"B={b} or L={l} does not fit int32 indices")
    if blocks.device.type == "cpu":
        return l1_argmin_ref(blocks, lib)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    return _l1_argmin_cuda(blocks, lib, stats)


# the JAX package's pure-XLA argmin is the chunked scan that
# `l1_argmin_ref` ports; the name stays for code written against its API
l1_argmin_xla = l1_argmin_ref


# ---------------------------------------------------------------------------
# Dense distance stripes (K10) and the exact top-k core
# ---------------------------------------------------------------------------

#: f32 bytes of one library chunk of `l1_block`'s cdist branch (integer
#: rows that are not u8; its output is bounded by the callers' row chunks)
_BLOCK_F32_BYTES = 1 << 30
#: int32 bytes of one [bc, L] stripe: callers chunk their query rows so a
#: stripe (and its f32 twin inside cdist) stays under this
_STRIPE_BYTES = 1 << 30


def _stripe_rows(n: int, width: int = 4) -> int:
    """Query rows per chunk so a [rows, n] stripe of `width`-byte entries
    stays under `_STRIPE_BYTES`."""
    return max(1, _STRIPE_BYTES // max(1, width * n))


def l1_block(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """dist[i, j] = sum_d |x[i, d] - t[j, d]| as int32 [bx, bt] on x's device.

    x, t: rows on one device, u8 vectors or the int32 group sums of the
    adaptive scorer. This is the dense stripe the JAX package leaves to
    XLA's fusion (`_stripe_score_env`, `_min_sum_stripe`), not a Pallas
    kernel. On the card, u8 rows go to K10's stripe entry
    (`csrc/l1_topcap.cu`), in exact integer arithmetic. Other rows go to
    `torch.cdist(p=1)` in f32, chunked over library rows; that is exact
    while every L1 sum stays below 2^24, as group sums of u8 cells do. On
    the card only K9's plain version (`_coarse_topcap_ref`) and
    `probes/seg8.py` send such rows. On the CPU it is `_l1_block_ref`,
    K10's plain version.
    """
    if x.dim() != 2 or t.dim() != 2 or x.shape[1] != t.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} / {tuple(t.shape)}")
    if x.device != t.device:
        raise ValueError(f"devices differ: {x.device} / {t.device}")
    if x.device.type == "cpu":
        return _l1_block_ref(x, t)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype == torch.uint8 and t.dtype == torch.uint8:
        return _l1_stripe_cuda(x, t)
    bx, d = x.shape
    bt = t.shape[0]
    out = torch.empty((bx, bt), dtype=torch.int32, device=x.device)
    if bx == 0 or bt == 0:
        return out
    xf = x.float()
    ch = max(1, min(_BLOCK_F32_BYTES // (4 * max(d, 1)), (1 << 28) // bx))
    for t0 in range(0, bt, ch):
        out[:, t0 : t0 + ch] = torch.cdist(xf, t[t0 : t0 + ch].float(), p=1)
    return out


def _l1_block_ref(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K10's stripe: `l1_block` by chunked int32
    abs-diff sums (cast first: u8 arithmetic wraps), on any device."""
    bx, d = x.shape
    bt = t.shape[0]
    out = torch.empty((bx, bt), dtype=torch.int32, device=x.device)
    if bx == 0 or bt == 0:
        return out
    xi = x.to(torch.int32)
    ti = t.to(torch.int32)
    bc, lc = _chunk_sizes(d)
    for b0 in range(0, bx, bc):
        xc = xi[b0 : b0 + bc, None, :]
        for t0 in range(0, bt, lc):
            out[b0 : b0 + bc, t0 : t0 + lc] = (
                (xc - ti[None, t0 : t0 + lc, :]).abs().sum(-1, dtype=torch.int32)
            )
    return out


#: K10's tiles (`csrc/l1_topcap.cu`): query rows and library rows per
#: tile (a library tile is one segment), the 4-byte words of a row that a
#: stage of its ring holds (two TMA boxes of 128 rows x 128 bytes for each
#: operand), the stages of each entry's ring, and each entry's shared
#: memory a block: 1024 bytes to align the ring, the ring, the top-cap's
#: int32 sums at the selection's stride, and 128 bytes of barriers
_K10_T = 128
_K10_KW = 64
_K10_STAGE_BYTES = 2 * (_K10_KW // 32) * _K10_T * 128
_K10_STRIPE_STAGES = 3
_K10_TOPCAP_STAGES = 2
_K10_STRIPE_SMEM = 1024 + _K10_STRIPE_STAGES * _K10_STAGE_BYTES + 128
_K10_TOPCAP_SMEM = 1024 + _K10_TOPCAP_STAGES * _K10_STAGE_BYTES + 4 * _K10_T * 132 + 128
#: tiles a launch at most (the kernel's tile indices are ints), and query
#: tiles (the TMA's row coordinates are ints)
_K10_MAX_TILES = 1 << 30
_K10_MAX_QTILES = (1 << 24) - 1


def _k10_plan(rows: int, l: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """K10's launch for `rows` query rows against l library rows of d
    bytes on a card of `sms` SMs: (row width in 4-byte words, padded to
    whole 16-byte vectors; query tiles; tiles, one per (query tile,
    library tile); blocks, one an SM or one a tile, whichever is fewer).
    Each block walks the tiles blockIdx.x, blockIdx.x + blocks, ... of the
    kernel's order (`tile_of`): groups of 8 query tiles, library tile by
    library tile in a group."""
    dw = -(-d // 16) * 4
    ntq = -(-rows // _K10_T)
    tiles = ntq * -(-l // _K10_T)
    return dw, ntq, tiles, min(sms, tiles)


def _k10_rows(l: int) -> int:
    """Query rows per K10 launch against l library rows: whole query tiles,
    at most `_K10_MAX_TILES` tiles and `_K10_MAX_QTILES` query tiles."""
    return max(1, min(_K10_MAX_TILES // -(-l // _K10_T), _K10_MAX_QTILES)) * _K10_T


def _k10_operands(x: torch.Tensor, t: torch.Tensor):
    """x and t zero-padded to whole 16-byte vectors and 16-byte aligned, as
    K10 reads them, and the padded width in 4-byte words."""
    dw = _k10_plan(1, 1, x.shape[1], 1)[0]
    return _pad_words(x, 4 * dw, 16), _pad_words(t, 4 * dw, 16), dw


def _l1_stripe_cuda(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bx, d = x.shape
    bt = t.shape[0]
    out = torch.empty((bx, bt), dtype=torch.int32, device=x.device)
    if bx == 0 or bt == 0:
        return out
    q, tt, dw = _k10_operands(x, t)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    step = _k10_rows(bt)
    for r0 in range(0, bx, step):
        rows = min(step, bx - r0)
        _, ntq, tiles, grid = _k10_plan(rows, bt, d, sms)
        L1_STRIPE.launch(
            x.device.index,
            ctypes.c_void_p(q[r0 : r0 + rows].data_ptr()),
            ctypes.c_void_p(tt.data_ptr()),
            ctypes.c_void_p(out[r0 : r0 + rows].data_ptr()),
            rows,
            bt,
            dw,
            ntq,
            tiles,
            grid,
            _K10_STRIPE_SMEM,
            ctypes.c_void_p(stream),
        )
    return out


def _keys(dist: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Packed int64 selection keys (dist << 32) | col: their order is the
    (distance, lowest row) order, and no two are equal."""
    return (dist.to(torch.int64) << 32) | cols.to(torch.int64)


def _unkey(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (keys >> 32).to(torch.int32), (keys & _MASK32).to(torch.int32)


def _least(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k least keys of each row, ascending."""
    if k >= keys.shape[-1]:
        return torch.sort(keys, dim=-1).values
    return torch.topk(keys, k, dim=-1, largest=False, sorted=True).values


def _topk_rows(dist: torch.Tensor, k: int, cols: torch.Tensor | None = None):
    """The k least (distance, col) pairs of each row of an int32 [r, n]
    matrix, ascending; `cols` (default: the column positions) names each
    entry. Returns (dists [r, k] i32, cols [r, k] i32)."""
    if cols is None:
        cols = torch.arange(dist.shape[1], device=dist.device)
    return _unkey(_least(_keys(dist, cols), k))


def _pad_topk(out_d, out_r, b: int, k: int, kk: int):
    """Shared top-k padding convention: when k exceeds the available rows
    (kk), trailing entries carry I32_MAX distances and row 0."""
    if kk < k:
        out_d = np.concatenate(
            [out_d, np.full((b, k - kk), I32_MAX, np.int32)], axis=1
        )
        out_r = np.concatenate(
            [out_r, np.zeros((b, k - kk), np.int32)], axis=1
        )
    return out_d, out_r


def l1_topk_stripes(blocks, lib, k: int, *, device=None):
    """Exact k nearest rows per block via full-library distance stripes.

    Same contract as `l1_topk` (ascending by (distance, row); I32_MAX
    padding when k > L): `l1_block` stripes of bounded row chunks, each
    selected on the packed key. Returns host numpy int32 arrays.
    """
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    kk = min(k, l)
    host = Assembly(dev)
    out_d = host.empty((b, kk), torch.int32)
    out_r = host.empty((b, kk), torch.int32)
    if b and kk:
        x, t = blocks.to(dev), lib.to(dev)
        bc = _stripe_rows(l)
        for b0 in range(0, b, bc):
            dd, rr = _topk_rows(l1_block(x[b0 : b0 + bc], t), kk)
            host.put(out_d[b0 : b0 + bc], dd)
            host.put(out_r[b0 : b0 + bc], rr)
    host.wait()
    return _pad_topk(out_d.numpy(), out_r.numpy(), b, k, kk)


def l1_argmin_stripes(
    blocks: torch.Tensor, lib: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact L1 nearest library row per block through `l1_block` stripes
    (K10's stripe entry on the card): the least packed (distance, row) key
    of each stripe row, so the lowest row wins ties. The JAX package's
    high-D argmin under its name; the contract of `l1_argmin` (u8 tensors
    on one device; (dist [B] int32, row [B] int32) on it)."""
    if blocks.dtype != torch.uint8 or lib.dtype != torch.uint8:
        raise TypeError(f"l1_argmin_stripes takes uint8, got {blocks.dtype}/{lib.dtype}")
    if blocks.dim() != 2 or lib.dim() != 2 or blocks.shape[1] != lib.shape[1]:
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(lib.shape)}")
    b, l = blocks.shape[0], lib.shape[0]
    if l == 0:
        raise ValueError("empty library")
    dist = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    row = torch.empty((b,), dtype=torch.int32, device=blocks.device)
    cols = torch.arange(l, device=blocks.device)
    bc = _stripe_rows(l, 8)
    for b0 in range(0, b, bc):
        key = _keys(l1_block(blocks[b0 : b0 + bc], lib), cols).amin(dim=1)
        dist[b0 : b0 + bc], row[b0 : b0 + bc] = _unkey(key)
    return dist, row


def _stripe_fallback(out_d, out_r, bad, blocks, lib, kk: int, *, device=None):
    """Shared uncertified-row fallback: exact stripe recompute for `bad`
    rows, written into the (host) outputs."""
    if bad.size:
        sel = torch.from_numpy(bad).to(blocks.device)
        fd, fr = l1_topk_stripes(blocks[sel], lib, kk, device=device)
        out_d[bad] = fd
        out_r[bad] = fr
    return out_d, out_r


def l1_dist_matrix(blocks, lib, *, device=None) -> np.ndarray:
    """Full [B, L] int32 L1 distance matrix (host numpy), the exact
    global-greedy no-repeat path's candidate lists (rendering.rs:320:
    under the reference's 32767-tile cap its 100k-NN fetch is the whole
    sorted list)."""
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    host = Assembly(dev)
    out = host.empty((b, l), torch.int32)
    x, t = blocks.to(dev), lib.to(dev)
    bc = _stripe_rows(l)
    for b0 in range(0, b, bc):
        host.put(out[b0 : b0 + bc], l1_block(x[b0 : b0 + bc], t))
    host.wait()
    return out.numpy()


# ---------------------------------------------------------------------------
# Full sorted lists on the card (K13)
#
# The exact-full no-repeat route sorts every row of the dense [B, L] matrix
# on the packed key (dist << bits_c) | col, bits_c = bitlen(L - 1): unique
# keys whose order is the (distance, lowest column) order. The key width
# follows the shape: u32 where bitlen(dmax) + bits_c <= 32, else u64.
# ---------------------------------------------------------------------------

#: K13 (`csrc/row_sort.cu`): warps a block, the widest digit of a radix
#: pass, the shared memory a block may take, and the keys a block sorts at
#: once on the long-row path (rows whose keys, twice over, and their u16
#: ranks pass that shared memory)
_K13_WARPS = 16
_K13_MAX_WIDTH = 8
_K13_SMEM_MAX = 227 * 1024
_K13_CHUNK = 4096
#: chunks a row at most (the long-row path's grid.y)
_K13_MAX_CHUNKS = 65535


def _k13_smem(cap: int, key_bytes: int, width: int) -> int:
    """Shared memory of a K13 block sorting `cap` keys at once: two key
    buffers, their u16 ranks, the (digit, warp) counts and the scan's warp
    sums."""
    return 2 * cap * key_bytes + 2 * cap + 4 * _K13_WARPS * ((1 << width) + 1)


def _k13_plan(n: int, dmax: int) -> tuple[int, int, int, int, int, int]:
    """K13's launch for rows of n >= 1 entries in [0, dmax]: (key bytes, 4
    where bitlen(dmax) + bits_c <= 32, else 8; bits_c = bitlen(n - 1), the
    column bits; radix passes and their digit width, as few passes of at
    most `_K13_MAX_WIDTH` bits as cover bitlen(dmax), at least one; the
    chunk, 0 where a block holds a whole row, else `_K13_CHUNK`; the shared
    memory a block)."""
    bits_c = (n - 1).bit_length()
    bits_d = dmax.bit_length()
    key_bytes = 4 if bits_d + bits_c <= 32 else 8
    passes = max(1, -(-bits_d // _K13_MAX_WIDTH))
    width = max(1, -(-bits_d // passes))
    smem = _k13_smem(-(-n // 8) * 8, key_bytes, width)
    if smem <= _K13_SMEM_MAX:
        return key_bytes, bits_c, passes, width, 0, smem
    return key_bytes, bits_c, passes, width, _K13_CHUNK, _k13_smem(_K13_CHUNK, key_bytes, width)


def _k13_work(rows: int, n: int, plan) -> int:
    """Bytes of K13's scratch: on the long-row path two [rows, n] key
    buffers and each row's counts of (digit, chunk), else none."""
    key_bytes, _, _, width, chunk, _ = plan
    if not chunk:
        return 0
    return 2 * rows * n * key_bytes + 4 * rows * (1 << width) * -(-n // chunk)


def row_sort(dist: torch.Tensor, dmax: int) -> torch.Tensor:
    """Every row of the int32 [B, L] matrix `dist`, whose entries lie in
    [0, dmax], in ascending (distance, column) order, the order of
    `np.argsort(kind="stable")`, on dist's device: where the plan's keys
    are 4 bytes, the keys (dist << bits_c) | col themselves, int32 [B, L]
    holding their u32 bits; else int32 [2, B, L], the distances, then the
    columns (`_k13_plan`; `sorted_lists` brings either to the host).

    On the card it launches the hand-written kernel K13 `csrc/row_sort.cu`;
    on a CPU tensor it runs `_row_sort_ref`, its plain torch version."""
    if dist.dim() != 2 or dist.dtype != torch.int32:
        raise ValueError(f"row_sort takes an int32 [B, L] matrix, got {dist.dtype} "
                         f"{tuple(dist.shape)}")
    if not 0 <= dmax < 2**31:
        raise ValueError(f"dmax must be in [0, 2^31), got {dmax}")
    if dist.device.type == "cpu":
        return _row_sort_ref(dist, dmax)
    if dist.device.type != "cuda":
        raise ValueError(f"unsupported device {dist.device}")
    if not dist.is_contiguous():
        raise ValueError("row_sort takes a contiguous matrix")
    b, n = dist.shape
    if -(-n // _K13_CHUNK) > _K13_MAX_CHUNKS:
        raise ValueError(f"K13 takes rows of at most {_K13_MAX_CHUNKS * _K13_CHUNK} entries")
    plan = _k13_plan(max(n, 1), dmax)
    key_bytes, bits_c, passes, width, chunk, smem = plan
    out = torch.empty((b, n) if key_bytes == 4 else (2, b, n), dtype=torch.int32,
                      device=dist.device)
    if b == 0 or n == 0:
        return out
    work = torch.empty(_k13_work(b, n, plan), dtype=torch.uint8, device=dist.device)
    ROW_SORT.launch(
        dist.device.index, dist.data_ptr(), out.data_ptr(),
        out[1].data_ptr() if key_bytes == 8 else None,
        work.data_ptr() if chunk else None, b, n, key_bytes, bits_c, passes, width, chunk,
        smem, torch.cuda.current_stream(dist.device).cuda_stream,
    )
    return out


def _row_sort_ref(dist: torch.Tensor, dmax: int) -> torch.Tensor:
    """Plain torch version of K13 (`row_sort`), on any device: the packed
    int64 keys of each row sorted, laid out as K13 writes them."""
    b, n = dist.shape
    key_bytes, bits_c = _k13_plan(max(n, 1), dmax)[:2]
    cols = torch.arange(n, dtype=torch.int64, device=dist.device)
    keys = torch.sort((dist.to(torch.int64) << bits_c) | cols, dim=1).values
    if key_bytes == 4:
        return (keys - (keys >> 31 << 32)).to(torch.int32)  # the u32 keys' bits
    return torch.stack(((keys >> bits_c).to(torch.int32),
                        (keys & ((1 << bits_c) - 1)).to(torch.int32)))


def sorted_lists(dist: torch.Tensor, dmax: int, *,
                 stats: dict | None = None) -> tuple[np.ndarray, int | None]:
    """The full sorted candidate lists of the matrix `dist` (int32 [B, L],
    entries in [0, dmax]) as they come to the host in one copy of
    `row_sort`'s output (`copies.to_host`): where the plan's keys are 4
    bytes, (keys, bits_c), the u32 keys [B, L] (dist << bits_c) | row and
    their column bits, which the native engine reads as they are
    (`native.greedy_global` with `bits_c`); else (lists, None), the int32
    [2, B, L] distances, then the rows.
    `unpack_lists` makes the (dists, rows) pair of either. `stats`, when
    given, gets the sort that ran (`sort`: "k13" on the card, "plain" on
    the CPU) and its key bytes (`key_bytes`)."""
    key_bytes, bits_c = _k13_plan(max(dist.shape[1], 1), dmax)[:2]
    if stats is not None:
        stats.update(sort="k13" if dist.is_cuda else "plain", key_bytes=key_bytes)
    out = _host(row_sort(dist, dmax))
    if key_bytes == 8:
        return out, None
    return out.view(np.uint32), bits_c


def unpack_lists(lists: np.ndarray, bits_c: int | None) -> tuple[np.ndarray, np.ndarray]:
    """The host int32 (dists [B, L], rows [B, L]) of `sorted_lists`' output:
    the u32 keys decoded into two fresh arrays, or the [2, B, L] lists'
    halves as they are."""
    if bits_c is None:
        return lists[0], lists[1]
    return ((lists >> np.uint32(bits_c)).view(np.int32),
            (lists & np.uint32((1 << bits_c) - 1)).view(np.int32))


#: `l1_topk` takes the dense stripes while B * L stays under this
_TOPK_MATRIX_BUDGET = 2 * 10**8


def l1_topk(blocks, lib, k: int, *, device=None, stats: dict | None = None):
    """k nearest library rows per block, ascending by (distance, row).

    Replaces kiddo `nearest_n` (rendering.rs:172-174 k=20 for --randomize;
    rendering.rs:307-321 candidate lists for global-greedy no-repeat).
    Small B*L: `l1_topk_stripes`, the dense stripes selected on the card;
    anything larger, or a library over the device budget: the adaptive
    certified scorer, which reroutes itself where it cannot prune. `stats`
    is passed on to `l1_topk_adaptive`.

    Returns:
      (dists [B, k] int32, rows [B, k] int32) numpy. If k > L, trailing
      entries carry I32_MAX distances.
    """
    device = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    if b * l > _TOPK_MATRIX_BUDGET or (
        lib.numel() > DEVICE_LIB_BYTES_MAX and l > _TL_SEG
    ):
        return l1_topk_adaptive(blocks, lib, k, device=device, stats=stats)
    return l1_topk_stripes(blocks, lib, k, device=device)


# ---------------------------------------------------------------------------
# Two-level exact top-k
#
# The library axis splits into 128-column segments; each keeps its `cap`
# least (distance, row) keys, and one global selection over the survivors
# gives the top k. A row is exact when no segment could have hidden a
# member: every segment's cap-th kept distance is strictly above the k-th
# (strict, because a truncated tie could have a lower row). Rows that do
# not certify are recomputed from full stripes.
# ---------------------------------------------------------------------------

#: library columns per stage-1 segment
_TL_SEG = 128
#: stage-1 survivors per segment
_TL_CAP = 8
#: invalid-column sentinel of the adaptive scorer's coarse distances
_TL_BIG = 2**30
#: query rows of the adaptive scorer's sample gate (and the floor of its
#: block slices): the JAX package's block chunk
_STRIPE_BC = 128


def _l1_topcap_ref(x: torch.Tensor, t: torch.Tensor, cap: int, col0: int,
                   real_l: int) -> torch.Tensor:
    """Plain torch version of K10's fused entry: the stripe
    (`_l1_block_ref`), the last segment's missing positions and the cols at
    or past real_l set to I32_MAX, then each 128-position segment's `cap`
    least packed keys by a torch.topk, in bounded row chunks. Returns int64
    [r, nseg, cap]."""
    rows, l = x.shape[0], t.shape[0]
    nseg = -(-l // _TL_SEG)
    lp = nseg * _TL_SEG
    cols = torch.arange(col0, col0 + lp, device=x.device)
    out = torch.empty((rows, nseg, cap), dtype=torch.int64, device=x.device)
    bc = _stripe_rows(lp, 8)
    for r0 in range(0, rows, bc):
        dist = torch.nn.functional.pad(_l1_block_ref(x[r0 : r0 + bc], t), (0, lp - l),
                                       value=I32_MAX)
        dist.masked_fill_(cols >= real_l, I32_MAX)
        out[r0 : r0 + bc] = _least(_keys(dist, cols).view(-1, nseg, _TL_SEG), cap)
        del dist
    return out


def _l1_topcap_cuda(x: torch.Tensor, t: torch.Tensor, cap: int, col0: int,
                    real_l: int) -> torch.Tensor:
    rows, d = x.shape
    l = t.shape[0]
    nseg = -(-l // _TL_SEG)
    out = torch.empty((rows, nseg, cap), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out
    q, tt, dw = _k10_operands(x, t)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    step = _k10_rows(l)
    for r0 in range(0, rows, step):
        r = min(step, rows - r0)
        _, ntq, tiles, grid = _k10_plan(r, l, d, sms)
        L1_TOPCAP.launch(
            x.device.index,
            ctypes.c_void_p(q[r0 : r0 + r].data_ptr()),
            ctypes.c_void_p(tt.data_ptr()),
            ctypes.c_void_p(out[r0 : r0 + r].data_ptr()),
            r,
            l,
            dw,
            ntq,
            tiles,
            grid,
            cap,
            col0,
            min(real_l, col0 + l),
            I32_MAX,
            _K10_TOPCAP_SMEM,
            ctypes.c_void_p(stream),
        )
    return out


def l1_topcap(x: torch.Tensor, t: torch.Tensor, cap: int, *, col0: int = 0,
              real_l: int | None = None) -> torch.Tensor:
    """Stage 1 of the two-level top-k: for u8 query rows x [r, D] against
    library rows t [L, D] (L >= 1) on one device, where row j of t has the
    col col0 + j, each 128-row segment of t keeps its `cap` least keys
    (distance << 32) | col, ascending, the lowest col first among equal
    distances. Positions whose col is at least real_l (default col0 + L),
    and the last segment's positions past L, are padding with the key
    (I32_MAX << 32) | col. 1 <= cap <= 128; col0 + 128 * nseg must fit an
    int32. Returns int64 [r, nseg, cap], nseg = ceil(L / 128).

    A CUDA tensor goes to K10's fused entry (`csrc/l1_topcap.cu`), which
    never writes the [r, L] distance stripe; a CPU tensor to
    `_l1_topcap_ref`.
    """
    if x.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise TypeError(f"l1_topcap takes uint8, got {x.dtype}/{t.dtype}")
    if x.dim() != 2 or t.dim() != 2 or x.shape[1] != t.shape[1] or t.shape[0] == 0:
        raise ValueError(f"shapes {tuple(x.shape)} / {tuple(t.shape)}")
    if not 1 <= cap <= _SEG_CAP_MAX:
        raise ValueError(f"cap must be in 1..{_SEG_CAP_MAX}, got {cap}")
    nseg = -(-t.shape[0] // _TL_SEG)
    if col0 < 0 or col0 + nseg * _TL_SEG > I32_MAX:
        raise ValueError(f"cols {col0}..{col0 + nseg * _TL_SEG} do not fit int32")
    if x.device != t.device:
        raise ValueError(f"devices differ: {x.device} / {t.device}")
    real_l = col0 + t.shape[0] if real_l is None else real_l
    if x.device.type == "cpu":
        return _l1_topcap_ref(x, t, cap, col0, real_l)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _l1_topcap_cuda(x, t, cap, col0, real_l)


def _twolevel_rows(nseg: int, cap: int) -> int:
    """Query rows per two-level chunk: its [rows, nseg, cap] survivor keys
    stay under `_AD_SURV_BYTES`."""
    return max(1, _AD_SURV_BYTES // (8 * nseg * cap))


def _twolevel_keys(x, t, kk: int, cap: int, col0: int = 0, real_l: int | None = None):
    """Both stages for the rows x against t (cols col0.., padding from
    real_l): `l1_topcap`, then the kk least survivors. Returns (keys [r, kk]
    int64 ascending, ok [r] bool): a row is exact when every segment's
    cap-th kept distance is strictly above its kk-th (a truncated tie
    could hide a lower col)."""
    return _certified_least(l1_topcap(x, t, cap, col0=col0, real_l=real_l), kk)


def _certified_least(seg: torch.Tensor, kk: int):
    """Stage 2 over stage-1 keys seg [r, nseg, cap]: the kk least survivors
    and each row's certificate (every segment's cap-th kept distance
    strictly above the kk-th)."""
    sel = _least(seg.flatten(1), kk)
    ok = ((seg[:, :, -1] >> 32) > (sel[:, kk - 1 :] >> 32)).all(dim=1)
    return sel, ok


def l1_topk_twolevel(blocks, lib, k: int, *, device=None):
    """Exact k nearest rows per block, same contract and results as
    `l1_topk_stripes`, via the segmented two-level selection with per-row
    certification and stripe fallback. Stage 1 is `l1_topcap` (K10's fused
    entry on the card)."""
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    nseg = -(-l // _TL_SEG)
    kk = min(k, l)
    if kk > min(l, nseg * _TL_CAP) or b == 0:
        return l1_topk_stripes(blocks, lib, k, device=dev)
    x, t = blocks.to(dev), lib.to(dev)
    host = Assembly(dev)
    out_d = host.empty((b, kk), torch.int32)
    out_r = host.empty((b, kk), torch.int32)
    ok = host.empty((b,), torch.bool)
    bc = _twolevel_rows(nseg, _TL_CAP)
    for b0 in range(0, b, bc):
        sel, good = _twolevel_keys(x[b0 : b0 + bc], t, kk, _TL_CAP)
        dd, rr = _unkey(sel)
        host.put(out_d[b0 : b0 + bc], dd)
        host.put(out_r[b0 : b0 + bc], rr)
        host.put(ok[b0 : b0 + bc], good)
    host.wait()
    out_d, out_r = out_d.numpy(), out_r.numpy()
    bad = np.flatnonzero(~ok.numpy())
    out_d, out_r = _stripe_fallback(out_d, out_r, bad, x, t, kk, device=dev)
    return _pad_topk(out_d, out_r, b, k, kk)


# ---------------------------------------------------------------------------
# Adaptive coarse-to-fine certified top-k (the no-repeat scorer)
#
# A projection that sums groups of g coordinates gives an exact L1 lower
# bound (|sum x - sum t| <= sum |x - t| per group) at 1/g of the work:
#   1. coarse stripes over STRIDED segments (segment s holds columns
#      {s + k*nseg}, so a run of similar tiles in discovery order spreads
#      over many segments) -> per-segment least `cap` coarse keys;
#   2. the m least survivors are the candidates; every other row has a
#      coarse bound >= c_next = min(worst kept per segment, first
#      unselected survivor);
#   3. exact full-D rescore of the candidates: K3 (`l1_rows`);
#   4. a row certifies when c_next > its k-th true distance (strict, for
#      ties); the others are recomputed from full stripes.
# Concentrated data (uniform noise) cannot be pruned: a sample chunk
# detects it and the call reroutes to the two-level scorer.
# ---------------------------------------------------------------------------

#: coarse group width preference (the first divisor of nc is used)
_AD_GROUPS = (32, 16, 8, 4)
#: coarse survivors per 128-column segment
_AD_CAP = 16
#: candidates rescored at full D per block
_AD_M = 1024
#: block-axis slice of the adaptive scorer
_AD_B_SLICE = 16384
#: device budget of the coarse survivor keys ([slice, nseg*cap] int64)
_AD_SURV_BYTES = 2 << 30
#: query rows per coarse chunk: its [rows, lp] int64 keys stay under
#: twice the stripe budget
_AD_COARSE_KEY_BYTES = 2 << 30
#: library rows per chunk of the coarse projection
_AD_PROJ_ROWS = 1 << 16
#: int32 bytes of the plain rescore's [rows, m, D] gather
_RESCORE_I32_BYTES = 64 << 20


def _ad_b_slice(nseg: int, cap: int, bc: int) -> int:
    """Block-axis slice length: `_AD_B_SLICE` capped by the survivor
    budget, floored to a (non-zero) multiple of bc."""
    rows = _AD_SURV_BYTES // (nseg * cap * 8)
    return max(bc, min(_AD_B_SLICE, rows // bc * bc))


def _ad_params(nseg: int, m: int = _AD_M, cap: int = _AD_CAP) -> tuple[int, int]:
    """Scale the adaptive scorer's (m, cap) to the library size: cap 8 past
    1024 segments (fewer expected survivors per segment), and m grows by
    ceil(nseg / 2048) so the rescore digs as deep into the survivor pool
    as the library grows. Exactness never depends on either."""
    if nseg > 1024:
        cap = min(cap, 8)
    m *= max(1, -(-nseg // 2048))
    return m, cap


def _ad_project(x: torch.Tensor, d: int, g: int, chan: bool) -> torch.Tensor:
    """Group-sum projection [r, d] -> int32 [r, dout], an L1 lower bound.
    `chan=True` sums g cells per RGB channel (palette coordinates
    interleave the channels), [r, nc/g, g, 3] summed over g; else g
    consecutive coordinates. An exact int32 sum: the TPU used a bf16
    selection matmul only because a size-3 minor dim tiles badly there."""
    r = x.shape[0]
    xi = x.to(torch.int32)
    if chan:
        return xi.reshape(r, d // (3 * g), g, 3).sum(2, dtype=torch.int32).reshape(r, -1)
    return xi.reshape(r, d // g, g).sum(2, dtype=torch.int32)


def _ad_plan(
    b: int, l: int, d: int, k: int, m: int = _AD_M, cap: int = _AD_CAP, *,
    device=None,
):
    """Adaptive-scorer eligibility and parameters:
    (eligible, g, chan, kk, lp, nseg, m, cap, use_k3). Ineligible shapes go
    to the two-level scorer. `use_k3` is whether the rescore runs K3 (a
    CUDA device); without it the rescore is the plain gather, which at
    production scale and D > 256 loses to the two-level scorer."""
    chan = d % 3 == 0
    nc = d // 3 if chan else d
    g = next(
        (
            gg
            for gg in _AD_GROUPS
            if nc % gg == 0 and (nc // gg) * (3 if chan else 1) >= 4
        ),
        None,
    )
    kk = min(k, l)
    lp = -(-l // _TL_SEG) * _TL_SEG
    nseg = lp // _TL_SEG
    m, cap = _ad_params(nseg, m, cap)
    use_k3 = device is not None and torch.device(device).type == "cuda"
    eligible = not (
        g is None
        or b == 0
        or kk > m // 2
        or m + 1 > nseg * cap
        or l <= 2 * m
        or (not use_k3 and d > 256 and b * l > 10**7)
    )
    return eligible, g, chan, kk, lp, nseg, m, cap, use_k3


def _pad_lib(lib: torch.Tensor, lp: int, dev) -> torch.Tensor:
    """The library on `dev`, zero-padded to lp rows (a multiple of 128)."""
    l, d = lib.shape
    lib_pad = torch.zeros((lp, d), dtype=torch.uint8, device=dev)
    lib_pad[:l] = lib.to(dev)
    return lib_pad


def _ad_coarse_lib(lib_pad: torch.Tensor, d: int, g: int, chan: bool, real_l: int):
    """The projected library in the layout K9 reads: f32 [nseg, dout, 128].
    Segment s holds the library rows k*nseg + s (k = 0..127; strided
    segments spread a run of similar tiles in discovery order over many
    segments), coordinate-major: proj[s, c, k] is coordinate c of row
    k*nseg + s. The group sums are integers below 2^24, exact in f32.
    Returns (proj, cols [lp] i32, the library row of position s*128 + k,
    real_l: positions whose row is at least real_l are padding)."""
    lp = lib_pad.shape[0]
    nseg = lp // _TL_SEG
    dev = lib_pad.device
    step = nseg * max(1, _AD_PROJ_ROWS // nseg)  # whole k rows at a time
    proj = None
    for r0 in range(0, lp, step):
        part = _ad_project(lib_pad[r0 : r0 + step], d, g, chan)
        if proj is None:
            proj = torch.empty((nseg, part.shape[1], _TL_SEG), dtype=torch.float32, device=dev)
        k0 = r0 // nseg
        proj[:, :, k0 : k0 + part.shape[0] // nseg] = part.view(-1, nseg, part.shape[1]).permute(
            1, 2, 0
        )
        del part
    pos = torch.arange(lp, device=dev)
    cols = (pos % _TL_SEG) * nseg + pos // _TL_SEG
    return proj, cols.to(torch.int32), real_l


def _ad_rows(proj: torch.Tensor) -> torch.Tensor:
    """A coarse library [nseg, dout, 128] as rows [lp, dout] in position
    order (row s*128 + k is position k of segment s), a copy."""
    nseg, dout, w = proj.shape
    return proj.permute(0, 2, 1).reshape(nseg * w, dout)


# ---------------------------------------------------------------------------
# Segment top-cap (K4) and the fused coarse pass (K9)
# ---------------------------------------------------------------------------

#: the most survivors a segment can keep
_SEG_CAP_MAX = _TL_SEG
#: K4's launch (`csrc/seg_topcap.cu`): (row, segment) chunks per block (one
#: thread each), and a chunk's stride in shared memory in 4-byte words: its
#: 128 values and 4 of padding, so the 16-byte reads of one chunk per
#: thread fall in distinct banks. K9 writes its sums at the same stride.
_K4_CHUNKS = 128
_SEG_ROW_WORDS = 132
#: K9's launch (`csrc/coarse_topcap.cu`): query rows of an item (one
#: segment of 128 positions each), coordinates of a stage, the stages of
#: each of its two teams' rings, and its shared memory a block: 128 bytes
#: to align the rings, then for each team its ring (each stage a [16, 128]
#: f32 box of each operand) and its int32 sums at the selection's stride,
#: and 64 bytes of barriers
_K9_TQ = 128
_K9_KT = 16
_K9_STAGES = 2
_K9_SMEM = 128 + 2 * (_K9_STAGES * 2 * _K9_KT * _K9_TQ * 4 + _K9_TQ * _SEG_ROW_WORDS * 4) + 64


def _k4_plan(rows: int, nseg: int) -> tuple[int, int]:
    """K4's launch for a [rows, nseg*128] stripe: (blocks, shared-memory
    bytes a block). Block i stages and selects chunks 128i..128i+127 of the
    rows*nseg (row, segment) chunks."""
    return -(-rows * nseg // _K4_CHUNKS), _K4_CHUNKS * _SEG_ROW_WORDS * 4


def _k9_plan(rows: int, nseg: int, dout: int, sms: int) -> tuple[int, int, int, int]:
    """K9's launch for `rows` projected query rows of `dout` coordinates
    against nseg segments on a card of `sms` SMs: (rpad, items, blocks,
    steps). Query rows are padded to rpad, a multiple of 128; an item is a
    (query tile, segment) pair; one block an SM, or one an item when there
    are fewer, walks the items blockIdx.x, blockIdx.x + blocks, ... of the
    kernel's order (`item_of`: groups of 8 query tiles, segment by segment
    in a group), its two teams taking them in turn; an item takes `steps`
    stages of 16 coordinates (the last one ragged)."""
    rpad = -(-rows // _K9_TQ) * _K9_TQ
    items = rpad // _K9_TQ * nseg
    return rpad, items, min(sms, items), -(-dout // _K9_KT)


def _seg_topcap_ref(
    dist: torch.Tensor, cols: torch.Tensor, cap: int, real_l: int
) -> torch.Tensor:
    """Plain torch version of K4: positions whose col is >= real_l count as
    `_TL_BIG`; each 128-position segment keeps its `cap` least packed
    (value, col) keys, ascending, by a torch.topk on the keys. Returns
    int64 [r, nseg*cap]."""
    nseg = dist.shape[1] // _TL_SEG
    dist = dist.masked_fill(cols >= real_l, _TL_BIG)
    return _least(_keys(dist, cols).view(-1, nseg, _TL_SEG), cap).flatten(1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels read 16-byte vectors;
    a fresh allocation is aligned)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _seg_topcap_cuda(
    dist: torch.Tensor, cols: torch.Tensor, cap: int, real_l: int
) -> torch.Tensor:
    r, lp = dist.shape
    nseg = lp // _TL_SEG
    d, c = _aligned(dist), _aligned(cols.to(torch.int32))
    out = torch.empty((r, nseg * cap), dtype=torch.int64, device=dist.device)
    if r == 0:
        return out
    blocks, smem = _k4_plan(r, nseg)
    SEG_TOPCAP.launch(
        dist.device.index,
        ctypes.c_void_p(d.data_ptr()),
        ctypes.c_void_p(c.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        r,
        nseg,
        cap,
        real_l,
        _TL_BIG,
        blocks,
        smem,
        ctypes.c_void_p(torch.cuda.current_stream(dist.device).cuda_stream),
    )
    return out


def seg_topcap(
    dist: torch.Tensor, cols: torch.Tensor, cap: int, real_l: int
) -> torch.Tensor:
    """Per-segment ascending top-`cap` of a segment-major distance stripe.

    dist [r, nseg*128] int32 (position s*128 + k in segment s), cols
    [nseg*128] integer, the library row of each position, growing with k
    within each segment (K4 relies on it and raises otherwise); 1 <= cap <=
    128. Positions with cols >= real_l count as `_TL_BIG`. Returns int64
    [r, nseg*cap]: per segment its `cap` least keys (value << 32) | col,
    ascending, the lowest col first among equal values. A CUDA tensor goes
    to K4 (`csrc/seg_topcap.cu`), a CPU tensor to `_seg_topcap_ref`.
    """
    if dist.dtype != torch.int32 or dist.dim() != 2 or dist.shape[1] % _TL_SEG:
        raise ValueError(
            f"seg_topcap takes an int32 [r, nseg*{_TL_SEG}] stripe, got "
            f"{dist.dtype} {tuple(dist.shape)}"
        )
    if cols.dim() != 1 or cols.shape[0] != dist.shape[1] or cols.is_floating_point():
        raise ValueError(f"cols must be integer [{dist.shape[1]}], got {tuple(cols.shape)}")
    if not 1 <= cap <= _SEG_CAP_MAX:
        raise ValueError(f"cap must be in 1..{_SEG_CAP_MAX}, got {cap}")
    if dist.device != cols.device:
        raise ValueError(f"devices differ: {dist.device} / {cols.device}")
    if dist.device.type == "cpu":
        return _seg_topcap_ref(dist, cols, cap, real_l)
    if dist.device.type != "cuda":
        raise ValueError(f"unsupported device {dist.device}")
    if cols.shape[0] and not bool((cols.view(-1, _TL_SEG).diff(dim=1) > 0).all()):
        raise ValueError("K4 takes cols that grow within each segment")
    return _seg_topcap_cuda(dist, cols, cap, real_l)


def seg_topk(seg: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment ascending top-`cap` of seg [bc, nseg, 128] int32 ->
    (vals [bc, nseg, cap] int32, idx [bc, nseg, cap] int32 lanes), the
    lowest lane first among equal values: the contract of
    `seg_topk_pallas` (tools/tpu_r14_seg8.py), bit-equal to
    `-lax.top_k(-seg, cap)` and its indices. As there, nseg is padded with
    `_TL_BIG` segments to a multiple of 128 and cut back. Runs `seg_topcap`
    (K4 on a CUDA tensor)."""
    bc, nseg, w = seg.shape
    if w != _TL_SEG:
        raise ValueError(f"segments must be {_TL_SEG} wide, got {w}")
    nseg2 = -(-nseg // _TL_SEG) * _TL_SEG
    if nseg2 != nseg:
        seg = torch.nn.functional.pad(seg, (0, 0, 0, nseg2 - nseg), value=_TL_BIG)
    lp = nseg2 * _TL_SEG
    cols = torch.arange(lp, dtype=torch.int32, device=seg.device)  # s*128 + lane
    keys = seg_topcap(seg.reshape(bc, lp), cols, cap, lp).view(bc, nseg2, cap)[:, :nseg]
    return (keys >> 32).to(torch.int32), (keys & (_TL_SEG - 1)).to(torch.int32)


def _coarse_topcap_ref(xp: torch.Tensor, proj: torch.Tensor, cols: torch.Tensor,
                       cap: int, real_l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K9: the coarse stripe `l1_block` of the
    projected rows xp [r, dout] against the coarse library proj [nseg,
    dout, 128] (as rows), then `_seg_topcap_ref`. Returns (keys
    [r, nseg*cap] i64, s_min [r] i32: the least over segments of the
    cap-th kept value)."""
    keys = _seg_topcap_ref(l1_block(xp, _ad_rows(proj)), cols, cap, real_l)
    worst = keys.view(keys.shape[0], -1, cap)[:, :, cap - 1] >> 32
    return keys, worst.min(dim=1).values.to(torch.int32)


def _coarse_topcap_cuda(xp, proj, cols, cap: int, real_l: int, keys, s_min) -> None:
    r, dout = xp.shape
    nseg = proj.shape[0]
    dev = xp.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rpad, items, grid, steps = _k9_plan(r, nseg, dout, sms)
    xt = torch.zeros((dout, rpad), dtype=torch.float32, device=dev)
    xt[:, :r] = xp.t()
    p, c = _aligned(proj), _aligned(cols)
    s_min.fill_(I32_MAX)
    COARSE_TOPCAP.launch(
        dev.index,
        ctypes.c_void_p(xt.data_ptr()),
        ctypes.c_void_p(p.data_ptr()),
        ctypes.c_void_p(c.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_void_p(s_min.data_ptr()),
        r,
        rpad,
        dout,
        nseg,
        cap,
        real_l,
        _TL_BIG,
        items,
        grid,
        steps,
        _K9_SMEM,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )


def coarse_topcap(xp: torch.Tensor, coarse_lib, cap: int, keys: torch.Tensor,
                  s_min: torch.Tensor) -> None:
    """The coarse pass's selection for projected query rows xp [r, dout]
    int32 against `coarse_lib` (`_ad_coarse_lib`): per segment the `cap`
    least keys (coarse distance << 32) | library row, ascending, the lowest
    row first among equal distances, padding rows at `_TL_BIG`, written
    into keys [r, nseg*cap] int64; and into s_min [r] int32 the least over
    segments of the cap-th kept distance. Both outputs contiguous, on xp's
    device. A CUDA tensor goes to K9 (`csrc/coarse_topcap.cu`), which never
    writes the [r, lp] distance stripe; a CPU tensor to
    `_coarse_topcap_ref`."""
    proj, cols, real_l = coarse_lib
    r = xp.shape[0]
    if proj.dim() != 3 or proj.shape[2] != _TL_SEG or proj.dtype != torch.float32:
        raise ValueError(f"coarse library must be f32 [nseg, dout, {_TL_SEG}], got "
                         f"{proj.dtype} {tuple(proj.shape)}")
    if xp.dim() != 2 or xp.shape[1] != proj.shape[1] or xp.dtype != torch.int32:
        raise ValueError(f"projected rows must be int32 [r, {proj.shape[1]}], got "
                         f"{xp.dtype} {tuple(xp.shape)}")
    if cols.dtype != torch.int32 or cols.shape != (proj.shape[0] * _TL_SEG,):
        raise ValueError(f"cols must be int32 [{proj.shape[0] * _TL_SEG}]")
    if not 1 <= cap <= _SEG_CAP_MAX:
        raise ValueError(f"cap must be in 1..{_SEG_CAP_MAX}, got {cap}")
    if (keys.shape != (r, proj.shape[0] * cap) or keys.dtype != torch.int64
            or s_min.shape != (r,) or s_min.dtype != torch.int32
            or not (keys.is_contiguous() and s_min.is_contiguous())):
        raise ValueError("keys must be contiguous int64 [r, nseg*cap], s_min int32 [r]")
    if not (xp.device == proj.device == cols.device == keys.device == s_min.device):
        raise ValueError("coarse_topcap's tensors are on different devices")
    if r == 0:
        return
    if xp.device.type == "cpu":
        k, m = _coarse_topcap_ref(xp, proj, cols, cap, real_l)
        keys.copy_(k)
        s_min.copy_(m)
        return
    if xp.device.type != "cuda":
        raise ValueError(f"unsupported device {xp.device}")
    _coarse_topcap_cuda(xp, proj, cols, cap, real_l, keys, s_min)


def _ad_coarse(x, coarse_lib, d: int, g: int, chan: bool, cap: int):
    """Step 1 for the blocks x [r, d]: per segment, the `cap` least coarse
    (bound, row) keys, through `coarse_topcap` (K9 on the card). Returns
    (keys [r, nseg*cap] i64, ascending within each segment; s_min [r] i32,
    the least over segments of the worst kept bound, part of the bound on
    every row not kept)."""
    proj = coarse_lib[0]
    nseg = proj.shape[0]
    r = x.shape[0]
    keys = torch.empty((r, nseg * cap), dtype=torch.int64, device=x.device)
    s_min = torch.empty((r,), dtype=torch.int32, device=x.device)
    bc = max(1, _AD_COARSE_KEY_BYTES // (8 * nseg * _TL_SEG))
    for b0 in range(0, r, bc):
        coarse_topcap(_ad_project(x[b0 : b0 + bc], d, g, chan), coarse_lib, cap,
                      keys[b0 : b0 + bc], s_min[b0 : b0 + bc])
    return keys, s_min


def _l1_rows_ref(
    blocks: torch.Tensor, cand: torch.Tensor, lib: torch.Tensor
) -> torch.Tensor:
    """Plain torch version of K3: dist[i, j] = L1(blocks[i],
    lib[min(cand[i, j], L-1)]) as int32 [B, m], by a chunked int32 gather
    and abs-sum."""
    b, d = blocks.shape
    m = cand.shape[1]
    l = lib.shape[0]
    out = torch.empty((b, m), dtype=torch.int32, device=blocks.device)
    idx = cand.clamp(0, l - 1).to(torch.int64)
    rows = max(1, _RESCORE_I32_BYTES // max(1, 4 * m * d))
    for b0 in range(0, b, rows):
        tc = lib[idx[b0 : b0 + rows]].to(torch.int32)  # [rows, m, D]
        xc = blocks[b0 : b0 + rows, None, :].to(torch.int32)
        out[b0 : b0 + rows] = (xc - tc).abs().sum(-1, dtype=torch.int32)
    return out


def _k3_plan(m: int, nvec: int) -> tuple[int, int]:
    """K3's path for m candidates per query and rows of `nvec` 16-byte
    vectors: (group, log2 of the candidate positions per pass). group = 0
    takes the per-query path (rows under `_K3_GROUPED_MIN_VEC` vectors, or
    one query row that does not fit beside the sort). Otherwise the group
    is the largest power of two of query rows that fits the shared memory
    beside the sort, at most `_K3_GROUP_MAX`, and no larger than lets one
    pass of `_K3_ENTRIES` entries cover each query's whole list; a pass
    takes min(whole list, entries / group) positions, a power of two."""
    room = (_K3_SMEM_BYTES - _K3_SORT_BYTES) // (16 * nvec)
    if nvec < _K3_GROUPED_MIN_VEC or room < 1:
        return 0, 0
    m2 = 1 << max(0, m - 1).bit_length()  # the least power of two >= m
    g = min(room, _K3_GROUP_MAX, max(1, _K3_ENTRIES // m2))
    g = 1 << (g.bit_length() - 1)
    return g, (min(_K3_ENTRIES // g, m2)).bit_length() - 1


def _l1_rows_cuda(
    blocks: torch.Tensor, cand: torch.Tensor, lib: torch.Tensor
) -> torch.Tensor:
    b, d = blocks.shape
    m = cand.shape[1]
    l = lib.shape[0]
    d16 = -(-d // 16) * 16
    q = _pad_words(blocks, d16, 16)
    t = _pad_words(lib, d16, 16)
    c = cand.to(torch.int32).contiguous()
    out = torch.empty((b, m), dtype=torch.int32, device=blocks.device)
    if b == 0 or m == 0:
        return out
    group, mc_log2 = _k3_plan(m, d16 // 16)
    # the grouped path's query order: bucket counts, buckets, permutation
    scratch = torch.empty((_K3_BUCKETS + 2 * b) if group else 0, dtype=torch.int32,
                          device=blocks.device)
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    sms = torch.cuda.get_device_properties(blocks.device).multi_processor_count
    L1_ROWS.launch(
        blocks.device.index,
        ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(c.data_ptr()),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr() if group else None),
        b,
        m,
        l,
        d16 // 16,
        group,
        mc_log2,
        sms * _ROWS_BLOCKS_PER_SM,
        ctypes.c_void_p(stream),
    )
    return out


def l1_rows(blocks: torch.Tensor, cand: torch.Tensor, lib: torch.Tensor) -> torch.Tensor:
    """dist[i, j] = exact L1(blocks[i], lib[min(cand[i, j], L-1)]).

    blocks [B, D] u8, cand [B, m] int32, lib [L, D] u8 (L >= 1), all on one
    device. A CUDA tensor goes to K3 (`csrc/l1_rows.cu`) for every D from 3
    to 49152 and libraries past 4 GiB (rows of 512 bytes and more through
    its grouped path, which fetches each distinct row once per group of
    queries; `_k3_plan`); a CPU tensor to `_l1_rows_ref`.
    Returns int32 [B, m] on that device.
    """
    if blocks.dtype != torch.uint8 or lib.dtype != torch.uint8:
        raise TypeError(f"l1_rows takes uint8, got {blocks.dtype}/{lib.dtype}")
    if cand.dtype != torch.int32:
        raise TypeError(f"l1_rows takes int32 candidates, got {cand.dtype}")
    if (
        blocks.dim() != 2 or lib.dim() != 2 or cand.dim() != 2
        or blocks.shape[1] != lib.shape[1] or cand.shape[0] != blocks.shape[0]
    ):
        raise ValueError(
            f"shapes {tuple(blocks.shape)} / {tuple(cand.shape)} / {tuple(lib.shape)}"
        )
    if lib.shape[0] == 0:
        raise ValueError("empty library")
    if not (blocks.device == cand.device == lib.device):
        raise ValueError(f"devices differ: {blocks.device} / {cand.device} / {lib.device}")
    if blocks.device.type == "cpu":
        return _l1_rows_ref(blocks, cand, lib)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    return _l1_rows_cuda(blocks, cand, lib)


def _ad_rescore(x, keys, s_min, lib_pad, *, m: int, k: int, real_l: int):
    """Steps 2-4: the m least coarse survivors as candidates, their exact
    distances (K3 on the card), the (distance, row) finish and the
    certificate. Returns (dists [r, k] i32, rows [r, k] i32, ok [r] bool)
    on the device."""
    sel = _least(keys, m + 1)
    cand = (sel[:, :m] & _MASK32).to(torch.int32)  # library rows
    c_next = torch.minimum(s_min, (sel[:, m] >> 32).to(torch.int32))
    del sel
    dist = l1_rows(x, cand, lib_pad)
    dist.masked_fill_(cand >= real_l, I32_MAX)
    dd, rr = _topk_rows(dist, k, cand)
    return dd, rr, c_next > dd[:, k - 1]


def _run_block_slices(x, b_slice: int, kk: int, run_slice):
    """Drive `run_slice` over b_slice-row windows of x and assemble
    (dists, rows, ok) on the host."""
    b = x.shape[0]
    host = Assembly(x.device)
    out_d = host.empty((b, kk), torch.int32)
    out_r = host.empty((b, kk), torch.int32)
    ok_all = host.empty((b,), torch.bool)
    for s0 in range(0, b, b_slice):
        dists, rows, ok = run_slice(x[s0 : s0 + b_slice])
        host.put(out_d[s0 : s0 + b_slice], dists)
        host.put(out_r[s0 : s0 + b_slice], rows)
        host.put(ok_all[s0 : s0 + b_slice], ok)
    host.wait()
    return out_d.numpy(), out_r.numpy(), ok_all.numpy()


def _ad_prepare(lib, d: int, b: int | None = None, k: int | None = None, *, device=None):
    """Pad and upload a library for `l1_topk_adaptive(prepared=...)`: the
    padding and upload the scorer does itself, factored out so
    `l1_topk_streamed` can upload the next bank from a worker thread while
    the current one scores. Returns the handle (lib_pad on the device,
    rows), or None for a query shape (`b`, `k`) that `_ad_plan` routes to
    the two-level scorer, which ignores the handle."""
    lib = _as_u8(lib)
    l = lib.shape[0]
    dev = lib.device if device is None else torch.device(device)
    if b is not None and k is not None and not _ad_plan(b, l, d, k, device=dev)[0]:
        return None
    lp = -(-l // _TL_SEG) * _TL_SEG
    return (_pad_lib(lib, lp, dev), l)


def _check_ad_prepared(prepared, l: int, lp: int, d: int):
    """Shape-check an `_ad_prepare` handle against THIS library (a
    mismatched handle would silently score the wrong rows); returns the
    padded device library."""
    lib_pad, rows_pre = prepared
    if rows_pre != l or lib_pad.numel() != lp * d:
        raise ValueError(
            f"prepared banks cover {rows_pre} rows x {lib_pad.numel()} "
            f"elements; this library needs {l} rows x {lp * d}"
        )
    return lib_pad


# ---------------------------------------------------------------------------
# Certificate self-audit
#
# The certificate trusts the coarse stage's own outputs, so a fault inside
# a stage is invisible to it. After every certified adaptive run at a
# large library, a random sample of blocks is rescored through the
# independent stripe scorer (no projection, no K3) and compared bit for
# bit; a mismatch prints a loud warning and rescored every block that way.
# ---------------------------------------------------------------------------

#: audit every certified adaptive run whose library has at least this
#: many rows. Override with EMOSAIC_AUDIT_ROWS; disable with
#: EMOSAIC_AUDIT=0; sample size via EMOSAIC_AUDIT_SAMPLE.
_AUDIT_MIN_ROWS = 1 << 19
#: f32 bytes of one library chunk of the audit's stripe scorer
_AUDIT_CHUNK_BYTES = 3 << 30


def _fold_topk_host(best_d, best_r, cd, cr, kk: int, l: int):
    """Fold one candidate chunk into a host-side running top-kk under the
    packed int64 (distance, lowest GLOBAL row) key, the one exact
    selection the streamed merge and the audit share. Padding entries
    carry I32_MAX distances and always lose; callers re-zero their rows
    at the end. (best_d is None) starts the fold."""
    if best_d is None:
        return cd, cr
    cat_d = np.concatenate([best_d, cd], axis=1)
    cat_r = np.concatenate([best_r, cr], axis=1)
    key = cat_d.astype(np.int64) * (l + 1) + cat_r
    part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
    order = np.argsort(np.take_along_axis(key, part, axis=1), axis=1)
    sel = np.take_along_axis(part, order, axis=1)
    return (
        np.take_along_axis(cat_d, sel, axis=1),
        np.take_along_axis(cat_r, sel, axis=1),
    )


def _stripes_banked(blocks, lib_dev, l: int, d: int, kk: int):
    """Exact top-kk per block over the device library `lib_dev` (rows past
    `l` are padding), by the stripe scorer in bounded row chunks folded
    with `_fold_topk_host`. Independent of the adaptive stages: the
    audit's ground truth, and its loud fallback."""
    b = blocks.shape[0]
    ch = max(_TL_SEG, _AUDIT_CHUNK_BYTES // (4 * d) // _TL_SEG * _TL_SEG)
    best_d = best_r = None
    for lo in range(0, l, ch):
        cl = min(ch, l - lo)
        kc = min(kk, cl)
        cd, cr = l1_topk_stripes(blocks, lib_dev[lo : lo + cl], kc, device=lib_dev.device)
        cr = cr + lo
        if kc < kk:  # chunk shorter than k: pad losers
            cd = np.concatenate([cd, np.full((b, kk - kc), I32_MAX, np.int32)], axis=1)
            cr = np.concatenate([cr, np.zeros((b, kk - kc), np.int32)], axis=1)
        best_d, best_r = _fold_topk_host(best_d, best_r, cd, cr, kk, l)
    best_r = np.where(best_d == I32_MAX, 0, best_r)
    return best_d, best_r


def _audit_would_run(l: int, b: int, kk: int) -> bool:
    """Whether `_ad_audit` scores at this geometry, under the same env
    knobs it reads."""
    if os.environ.get("EMOSAIC_AUDIT", "1") == "0":
        return False
    min_rows = int(os.environ.get("EMOSAIC_AUDIT_ROWS", str(_AUDIT_MIN_ROWS)))
    return l >= min_rows and b > 0 and kk > 0


def _ad_audit(out_d, out_r, blocks, lib_dev, l: int, d: int, kk: int, *, label):
    """Post-hoc exactness audit of a certified adaptive result. Returns
    (out_d, out_r) unchanged when the sample equals the stripe scorer bit
    for bit, else the stripe scorer's result for every block, after a
    loud warning on stderr."""
    b = blocks.shape[0]
    if not _audit_would_run(l, b, kk):
        return out_d, out_r
    ns = min(b, max(1, int(os.environ.get("EMOSAIC_AUDIT_SAMPLE", "32"))))
    rng = np.random.default_rng(0xAD17 + 31 * b + l)
    idx = np.sort(rng.choice(b, size=ns, replace=False))
    ad, ar = _stripes_banked(
        blocks[torch.from_numpy(idx).to(blocks.device)], lib_dev, l, d, kk
    )
    row_ok = (ad == out_d[idx]).all(axis=1) & (ar == out_r[idx]).all(axis=1)
    if row_ok.all():
        return out_d, out_r
    print(
        f"⚠️  EXACTNESS AUDIT FAILED ({label}): "
        f"{int((~row_ok).sum())}/{ns} sampled blocks disagree with the "
        f"independent stripe oracle at L={l} D={d} — the certificate "
        f"cannot be trusted for this run; re-scoring all {b} blocks "
        "through the oracle (exact, slower)",
        file=sys.stderr,
    )
    return _stripes_banked(blocks, lib_dev, l, d, kk)


def l1_topk_adaptive(
    blocks,
    lib,
    k: int,
    *,
    m: int = _AD_M,
    cap: int = _AD_CAP,
    prepared=None,
    device=None,
    stats: dict | None = None,
):
    """Exact k nearest rows per block, same contract and results as
    `l1_topk_stripes`, via the adaptive coarse-to-fine certified scorer
    (section comment above). Falls back to `l1_topk_twolevel` wholesale
    when a sample chunk cannot certify (concentrated data), and per row to
    the stripes for uncertified rows.

    `prepared` is an `_ad_prepare` handle for THIS `lib` (the streamed
    scorer's prefetch); results are bit-identical with or without it.
    `stats`, when given, is filled with the route taken and the counts of
    certified and fallback rows, and the steps' spans (`scoring.prepare`,
    `.coarse`, `.rescore`, `.fallback`, `.audit`) then end in a synchronize.
    """
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, d = blocks.shape
    l = lib.shape[0]
    st = stats if stats is not None else {}
    st.update(route="adaptive", blocks=b)
    if lib.numel() > DEVICE_LIB_BYTES_MAX and l > _TL_SEG:
        # beyond the device budget: stream banks (each bank is under it,
        # so the per-bank calls stay direct)
        st["route"] = "streamed"
        return l1_topk_streamed(blocks, lib, k, device=dev)
    eligible, g, chan, kk, lp, nseg, m, cap, _ = _ad_plan(
        b, l, d, k, m, cap, device=dev
    )
    if not eligible:
        st["route"] = "twolevel (ineligible shape)"
        return l1_topk_twolevel(blocks, lib, k, device=dev)
    with span("scoring.prepare"):
        if prepared is not None:
            lib_pad = _check_ad_prepared(prepared, l, lp, d)
        else:
            lib_pad = _pad_lib(lib, lp, dev)
        lib_dev = lib_pad[:l]
        x = blocks.to(dev)
        bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
        b_slice = _ad_b_slice(nseg, cap, bc)
        coarse_lib = _ad_coarse_lib(lib_pad, d, g, chan, l)
        if stats is not None:
            _sync(dev)

    def run(xs):
        with span("scoring.coarse"):
            keys, s_min = _ad_coarse(xs, coarse_lib, d, g, chan, cap)
            if stats is not None:
                _sync(dev)
        with span("scoring.rescore"):
            out = _ad_rescore(xs, keys, s_min, lib_pad, m=m, k=kk, real_l=l)
            if stats is not None:
                _sync(dev)
        return out

    # adaptivity gate: one sample chunk through the whole pipeline; data
    # no lossy projection can prune (uniform noise) fails it
    if b > bc:
        _, _, ok_s = run(x[:bc])
        if ok_s.float().mean().item() < 0.5:
            st["route"] = "twolevel (sample gate)"
            return l1_topk_twolevel(x, lib_dev, k, device=dev)
    out_d, out_r, ok_all = _run_block_slices(x, b_slice, kk, run)
    st.update(certified=int(ok_all.sum()))
    bad = np.flatnonzero(~ok_all)
    with span("scoring.fallback"):
        out_d, out_r = _stripe_fallback(out_d, out_r, bad, x, lib_dev, kk, device=dev)
    with span("scoring.audit"):
        out_d, out_r = _ad_audit(
            out_d, out_r, x, lib_dev, l, d, kk, label="l1_topk_adaptive"
        )
    st.update(fallback=int(bad.size), audit=_audit_would_run(l, b, kk))
    return _pad_topk(out_d, out_r, b, k, kk)


#: the streamed scorer's prefetch protocol: scorers exposing `prepare`
#: get next-bank uploads issued from a worker thread (l1_topk_streamed)
l1_topk_adaptive.prepare = _ad_prepare


def _stream_bank_rows(d: int) -> int:
    """Rows per streamed bank: the device budget's worth of rows, a
    multiple of 128 (`_TL_SEG`), at least one segment."""
    return max(_TL_SEG, DEVICE_LIB_BYTES_MAX // max(d, 1) // _TL_SEG * _TL_SEG)


def l1_topk_streamed(blocks, lib, k: int, *, bank_rows: int | None = None,
                     scorer=None, device=None):
    """Exact k nearest rows per block, same contract and results as
    `l1_topk_stripes`, for libraries too large to keep on the device
    (`DEVICE_LIB_BYTES_MAX`): each `bank_rows`-row bank is scored with the
    certified adaptive scorer, and the banks fold with an exact
    (distance, global row) merge on the host. Every global top-k member is
    in its own bank's top-k, so the union of the bank lists holds it.

    `scorer` replaces the per-bank scorer (default: `l1_topk_adaptive` on
    `device`). When it has a `prepare(lib_slice, d, b, k)` attribute, the
    next bank is uploaded from a worker thread while the current one
    scores, and its handle comes back through `prepared=`; two banks are
    then resident, so automatic banks halve. An explicit `bank_rows` is
    clamped to the budget; when two of them do not fit, the upload runs
    serially. EMOSAIC_STREAM_PREFETCH=0 disables the prefetch. Results are
    bit-identical either way.
    """
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    if scorer is None:

        def score(bb, ll, kx, prepared=None):
            return l1_topk_adaptive(bb, ll, kx, prepared=prepared, device=dev)

        score.prepare = lambda ll, dd, b_=None, kx=None: _ad_prepare(
            ll, dd, b_, kx, device=dev
        )
    else:
        score = scorer
    b, d = blocks.shape
    l = lib.shape[0]
    rb = _stream_bank_rows(d) if bank_rows is None else bank_rows
    rb = max(_TL_SEG, min(rb, DEVICE_LIB_BYTES_MAX // d // _TL_SEG * _TL_SEG))
    if b == 0:
        # a direct empty result: re-entering a scorer would bounce off the
        # oversized-library gates straight back here
        return np.full((0, k), I32_MAX, np.int32), np.zeros((0, k), np.int32)
    if l <= rb:
        return score(blocks, lib, k)
    prep = getattr(score, "prepare", None)
    prefetch = prep is not None and os.environ.get(
        "EMOSAIC_STREAM_PREFETCH", "1"
    ) != "0"
    if prefetch and bank_rows is None:
        rb = max(
            _TL_SEG,
            min(rb, DEVICE_LIB_BYTES_MAX // 2 // d // _TL_SEG * _TL_SEG),
        )
    elif prefetch and 2 * rb * d > DEVICE_LIB_BYTES_MAX:
        print(
            f"   stream prefetch disabled: two explicit {rb}-row banks "
            "exceed the device-resident budget; uploading serially",
            file=sys.stderr,
        )
        prefetch = False
    kk = min(k, l)
    offs = range(0, l, rb)

    def bank_results():
        if not prefetch:
            for off in offs:
                dd, rr = score(blocks, lib[off : off + rb], kk)
                yield off, dd, rr
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(prep, lib[:rb], d, b, kk)
            for off in offs:
                handle = fut.result()
                if off + rb < l:
                    fut = ex.submit(prep, lib[off + rb : off + 2 * rb], d, b, kk)
                dd, rr = score(blocks, lib[off : off + rb], kk, prepared=handle)
                yield off, dd, rr

    best_d = best_r = None
    for off, dd, rr in bank_results():
        rr = rr + off  # global rows (padding entries re-zeroed below)
        best_d, best_r = _fold_topk_host(best_d, best_r, dd, rr, kk, l)
    best_r = np.where(best_d == I32_MAX, 0, best_r)
    return _pad_topk(best_d, best_r, b, k, kk)


# ---------------------------------------------------------------------------
# Hybrid: squared-L2 prefilter + exact-L1 rescore (K3), and the L2 argmin,
# both scored on K11
#
# APPROXIMATE and opt-in (`--matcher hybrid`, `--metric l2`), as in the
# JAX package: the hybrid's candidates are the k_pre rows of least squared
# L2 distance, re-ranked and distanced in exact int32 L1, and the
# candidate set is not guaranteed to hold the L1 top k. The squared
# distances are exact integers: K11 (`csrc/l2_score.cu`) takes the u8
# product on the tensor cores in s32 and forms |x|^2 + |t|^2 - 2 x.t; the
# plain versions take an f64 product of the u8 values (`_l2_dense`, exact
# for any D). The JAX package scores |t|^2 - 2 x.t (|x|^2 is constant per
# query) in f32, exact while 255^2 * D < 2^24 (D <= 258, modes <= 9):
# there both orders agree, lowest row first among equal scores. Above that
# the JAX package's order follows its f32 sums, and the port's is the
# exact one (README). The JAX package's approx_min_k returns the same
# scores on the CPU, but which of several equal scores at its cut it
# keeps follows no rule: an accepted divergence (README), pinned by the
# tied-data tests of tests/test_torch_hybrid.py.
#
# The prefilter is the two-level selection of `l1_topk_twolevel` under
# squared L2: `l2_topcap` keeps each segment's cap least keys (K11's fused
# entry writes no [rows, L] stripe), `_certified_least` the k_pre least
# survivors and each row's certificate, and rows that do not certify run
# again with every 128-row segment kept whole, exact by construction.
# ---------------------------------------------------------------------------

#: K11's tiles (`csrc/l2_score.cu`): the depth of one tensor-core step
#: (rows pad to a multiple of it), the argmin's (query, library) tile, a
#: top-cap item's scores (query rows x segment), the segments a plan may
#: pick (longest first), the largest cap the selection takes from the 32
#: group minima (a larger one ranks the whole segment, seg^2 compares a
#: row), the widest padded rows of the argmin's packed key (the faster
#: epilogue up to here on an H100; the key itself fits up to 4128 bytes),
#: the first padded width whose dot products take the split depth
#: (255^2 * dp >= 2^31), and the widest rows (dist^2 < 2^32)
_K11_KC = 32
_K11_ARG_TILE = (128, 256)
_K11_TILE_SCORES = 32768
_K11_SEGS = (1024, 512, 256, 128)
_K11_GROUP_CAP = 32
_K11_PACKED_MAX_DP = 128
_K11_SPLIT_MIN_DP = 33056
_K11_D_MAX = 66051
#: the widest padded rows whose top-cap keys pack into u32: dist^2 << 10 |
#: position (the kernel's PACKED_TOP_MAX_DP)
_K11_PACKED_TOP_MAX_DP = 64
#: K11's ring of cp.async stages (rows of 32 bytes at a 48-byte stride),
#: its warps a block, the argmin's slots of 256-entry |t|^2 rows (a tile's
#: row lands with its first k-step, so the ring must stay shorter than the
#: slots) and its shared memory: the ring, the slots and the query tile's
#: |x|^2
_K11_ROWB = 48
_K11_STAGES = 3
_K11_WARPS = 16
_K11_TN_SLOTS = 4
_K11_ARG_SMEM = (_K11_STAGES * sum(_K11_ARG_TILE) * _K11_ROWB
                 + _K11_TN_SLOTS * _K11_ARG_TILE[1] * 4 + _K11_ARG_TILE[0] * 4)
#: argmin blocks an SM (one at a time) that fill the card: fewer query
#: tiles split the library
_K11_ARG_WAVES = 2


def _k11_dp(d: int) -> int:
    """K11's row width: d bytes zero-padded to a multiple of 32."""
    return max(_K11_KC, -(-d // _K11_KC) * _K11_KC)


def _k11_bias(dp: int) -> int:
    """The top-cap keys' offset of dist^2: 2^31 where dist^2 may reach 2^31
    (so the high word keeps its order as a signed int), else 0."""
    return 1 << 31 if dp >= _K11_SPLIT_MIN_DP else 0


def _k11_topcap_smem(seg: int) -> int:
    """A top-cap block's shared memory: the ring or, over it after the
    product, the u32 [bm, seg + 8] dist^2 tile, whichever is larger, then
    |x|^2, |t|^2 and sixteen warps' u16 candidate lists."""
    bm = _K11_TILE_SCORES // seg
    ring = _K11_STAGES * (bm + seg) * _K11_ROWB
    return max(ring, bm * (seg + 8) * 4) + (bm + seg) * 4 + _K11_WARPS * seg * 2


def _k11_argmin_plan(rows: int, l: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """K11's argmin launch for `rows` u8 rows of d bytes against l library
    rows on `sms` SMs: (row width, query tiles, library splits, library
    tiles a split). The library splits until the blocks reach
    `_K11_ARG_WAVES` an SM, at most one split a library tile."""
    bm, bn = _K11_ARG_TILE
    nqt = -(-rows // bm)
    ntl = -(-l // bn)
    tps = -(-ntl // max(1, min(ntl, -(-_K11_ARG_WAVES * sms // nqt))))
    return _k11_dp(d), nqt, -(-ntl // tps), tps


def _k11_cap(k_pre: int, l: int, seg: int) -> int:
    """Survivors a segment keeps for a k_pre cut: the expected members of
    the k_pre in a segment, e = k_pre * seg / l, plus 4 sqrt(e) + 4 (on
    data without runs of similar rows, a tail the certificate rarely
    reaches)."""
    e = k_pre * seg / l
    return math.ceil(e + 4 * math.sqrt(e) + 4)


def _k11_topcap_plan(l: int, k_pre: int) -> tuple[int, int]:
    """(segment length, cap) of the prefilter's stage 1 for k_pre <= l: the
    longest segment whose cap is at most 32 and at most seg / 16 (the
    survivors stay within 1/16 of the positions) and whose survivors hold
    k_pre. Where k_pre is too large a share of the library for any, 128-row
    segments with their cap, raised until the survivors hold k_pre, at most
    the whole segment (caps above 32 rank the whole segment)."""
    for seg in _K11_SEGS:
        cap = _k11_cap(k_pre, l, seg)
        if cap <= min(_K11_GROUP_CAP, seg // 16) and -(-l // seg) * cap >= k_pre:
            return seg, cap
    nseg = -(-l // _TL_SEG)
    return _TL_SEG, min(_TL_SEG, max(_k11_cap(k_pre, l, _TL_SEG), -(-k_pre // nseg)))


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 holding their low 32 bits."""
    return (((v + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|row|^2 of u8 rows as int32 holding the low 32 bits (exact below
    2^31: D <= 33025), in row chunks of bounded int32 temporaries."""
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    step = max(1, _RESCORE_I32_BYTES // (4 * max(x.shape[1], 1)))
    for r0 in range(0, x.shape[0], step):
        xi = x[r0 : r0 + step].to(torch.int32)
        out[r0 : r0 + step] = (xi * xi).sum(1, dtype=torch.int64)
    return _wrap32(out)


def _k11_lib(t: torch.Tensor):
    """K11's library operand, made once a library: (its rows zero-padded to
    `_k11_dp` bytes and 16-byte aligned, |t|^2 from `_sq_norms`)."""
    return _pad_words(t, _k11_dp(t.shape[1]), 16), _sq_norms(t)


def _check_l2(x: torch.Tensor, t: torch.Tensor, what: str) -> None:
    if x.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise TypeError(f"{what} takes uint8, got {x.dtype}/{t.dtype}")
    if x.dim() != 2 or t.dim() != 2 or x.shape[1] != t.shape[1] or t.shape[0] == 0:
        raise ValueError(f"shapes {tuple(x.shape)} / {tuple(t.shape)}")
    if x.shape[1] > _K11_D_MAX:
        raise ValueError(f"rows of {x.shape[1]} bytes: squared distances reach 2^32 "
                         f"(at most {_K11_D_MAX} bytes)")
    if x.device != t.device:
        raise ValueError(f"devices differ: {x.device} / {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


@contextlib.contextmanager
def _full_f32():
    """float32 matrix products in full float32 inside the block, whatever
    the process-wide setting: TF32 keeps 10 mantissa bits and would round
    integer sums. The L2 routes no longer take f32 products; the f32
    route K11 replaced is `chip_smoke.py`'s yardstick for it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _l2_dense(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Exact squared distances int64 [r, L] of u8 rows x against t:
    |x|^2 + |t|^2 - 2 x.t from an f64 product of the u8 values (every
    partial sum an integer below 2^53, exact in any order), over library
    chunks of `_BLOCK_F32_BYTES // (4 D)` rows (the chunks of the f32 route
    that came before; twice their bytes in f64)."""
    xd = x.double()
    xn = (xd * xd).sum(1)
    out = torch.empty((x.shape[0], t.shape[0]), dtype=torch.int64, device=x.device)
    ch = max(1, _BLOCK_F32_BYTES // (4 * max(t.shape[1], 1)))
    for t0 in range(0, t.shape[0], ch):
        tf = t[t0 : t0 + ch].double()
        out[:, t0 : t0 + ch] = (xn[:, None] + (tf * tf).sum(1)[None, :]
                                - 2.0 * (xd @ tf.T)).to(torch.int64)
    return out


def _l2_argmin_ref(x: torch.Tensor, t: torch.Tensor):
    """Plain torch version of K11's argmin entry: `_l2_dense`'s exact
    squared distances in row chunks, the first least of each row, so the
    lowest row wins ties. Returns (dist^2 [r] int32, wrapping past D =
    33025 as the JAX package's int32 does; row [r] int32)."""
    dist = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    row = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    bc = _stripe_rows(t.shape[0], 8)
    for b0 in range(0, x.shape[0], bc):
        dist[b0 : b0 + bc], row[b0 : b0 + bc] = _l2_dense(x[b0 : b0 + bc], t).min(dim=1)
    return _wrap32(dist), row.to(torch.int32)


def _l2_argmin_cuda(x: torch.Tensor, t: torch.Tensor):
    rows, d = x.shape
    l = t.shape[0]
    keys = torch.full((rows,), -1, dtype=torch.int64, device=x.device)  # ~0 as u64
    if rows:
        tp, tn = _k11_lib(t)
        dp = tp.shape[1]
        xp, xn = _pad_words(x, dp, 16), _sq_norms(x)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, nqt, nsplit, tps = _k11_argmin_plan(rows, l, d, sms)
        L2_ARGMIN.launch(
            x.device.index,
            ctypes.c_void_p(xp.data_ptr()),
            ctypes.c_void_p(tp.data_ptr()),
            ctypes.c_void_p(xn.data_ptr()),
            ctypes.c_void_p(tn.data_ptr()),
            ctypes.c_void_p(keys.data_ptr()),
            rows,
            l,
            dp,
            nqt,
            nsplit,
            tps,
            _K11_ARG_SMEM,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    return _unkey(keys)


def _l2_argmin(x: torch.Tensor, t: torch.Tensor):
    """(dist^2 [r] int32, row [r] int32) on x's device: the least squared
    distance of each u8 row of x against the rows of t, the lowest row
    among equal ones; dist^2 wraps past D = 33025 as the JAX package's
    int32 does. A CUDA tensor goes to K11's argmin entry
    (`csrc/l2_score.cu`), which writes no [r, L] score stripe; a CPU
    tensor to `_l2_argmin_ref`."""
    _check_l2(x, t, "l2 argmin")
    if x.device.type == "cpu":
        return _l2_argmin_ref(x, t)
    return _l2_argmin_cuda(x, t)


def _l2_topcap_ref(x: torch.Tensor, t: torch.Tensor, cap: int, seg: int, col0: int,
                   real_l: int) -> torch.Tensor:
    """Plain torch version of K11's fused entry: `_l2_dense`'s exact
    squared distances less the bias, the last segment's missing positions
    and the cols at or past real_l set to I32_MAX, then each segment's cap
    least packed keys by `_least`, in bounded row chunks. Returns int64
    [r, nseg, cap]."""
    rows, l = x.shape[0], t.shape[0]
    nseg = -(-l // seg)
    lp = nseg * seg
    bias = _k11_bias(_k11_dp(x.shape[1]))
    cols = torch.arange(col0, col0 + lp, device=x.device)
    out = torch.empty((rows, nseg, cap), dtype=torch.int64, device=x.device)
    bc = _stripe_rows(lp, 8)
    for r0 in range(0, rows, bc):
        hi = torch.nn.functional.pad(_l2_dense(x[r0 : r0 + bc], t) - bias, (0, lp - l),
                                     value=I32_MAX)
        hi.masked_fill_(cols >= real_l, I32_MAX)
        out[r0 : r0 + bc] = _least(_keys(hi, cols).view(-1, nseg, seg), cap)
        del hi
    return out


def _l2_topcap_cuda(x: torch.Tensor, prepared, cap: int, seg: int, col0: int,
                    real_l: int) -> torch.Tensor:
    tp, tn = prepared
    rows = x.shape[0]
    l, dp = tp.shape
    nseg = -(-l // seg)
    out = torch.empty((rows, nseg, cap), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out
    xp, xn = _pad_words(x, dp, 16), _sq_norms(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bm = _K11_TILE_SCORES // seg
    step = max(1, I32_MAX // nseg) * bm  # items (query tiles x segments) fit an int
    for r0 in range(0, rows, step):
        r = min(step, rows - r0)
        nqt = -(-r // bm)
        L2_TOPCAP.launch(
            x.device.index,
            ctypes.c_void_p(xp[r0 : r0 + r].data_ptr()),
            ctypes.c_void_p(tp.data_ptr()),
            ctypes.c_void_p(xn[r0 : r0 + r].data_ptr()),
            ctypes.c_void_p(tn.data_ptr()),
            ctypes.c_void_p(out[r0 : r0 + r].data_ptr()),
            r,
            l,
            dp,
            seg,
            cap,
            col0,
            max(0, min(l, real_l - col0)),
            _k11_bias(dp),
            nqt,
            nqt * nseg,
            _k11_topcap_smem(seg),
            ctypes.c_void_p(stream),
        )
    return out


def l2_topcap(x: torch.Tensor, t: torch.Tensor, cap: int, *, seg: int = _TL_SEG,
              col0: int = 0, real_l: int | None = None, prepared=None) -> torch.Tensor:
    """Stage 1 of the two-level top-k under squared L2, the contract of
    `l1_topcap` with `seg`-row segments (128, 256, 512 or 1024): for u8
    query rows x [r, D] against library rows t [L, D] (L >= 1, D <= 66051)
    on one device, where row j of t has the col col0 + j, each segment
    keeps its `cap` least keys ((dist^2 - bias) << 32) | col, ascending,
    the lowest col first among equal distances; bias is 2^31 for rows
    padded past 33024 bytes (`_k11_bias`, where dist^2 may pass 2^31),
    else 0. Positions whose col is at least real_l (default col0 + L), and
    the last segment's positions past L, are padding with the key
    (I32_MAX << 32) | col. 1 <= cap <= seg (a cap above 32 ranks the whole
    segment). Returns int64 [r, nseg, cap], nseg = ceil(L / seg).

    A CUDA tensor goes to K11's fused entry (`csrc/l2_score.cu`), which
    never writes the [r, L] stripe; `prepared` (`_k11_lib(t)`) spares the
    library's padding and norms on a repeated t. A CPU tensor goes to
    `_l2_topcap_ref`.
    """
    _check_l2(x, t, "l2_topcap")
    if seg not in _K11_SEGS:
        raise ValueError(f"seg must be one of {_K11_SEGS}, got {seg}")
    if not 1 <= cap <= seg:
        raise ValueError(f"cap must be in 1..{seg}, got {cap}")
    nseg = -(-t.shape[0] // seg)
    if col0 < 0 or col0 + nseg * seg > I32_MAX:
        raise ValueError(f"cols {col0}..{col0 + nseg * seg} do not fit int32")
    real_l = col0 + t.shape[0] if real_l is None else real_l
    if x.device.type == "cpu":
        return _l2_topcap_ref(x, t, cap, seg, col0, real_l)
    return _l2_topcap_cuda(x, prepared or _k11_lib(t), cap, seg, col0, real_l)


def _l2_least(x: torch.Tensor, t: torch.Tensor, k_pre: int, seg: int, cap: int,
              prepared) -> tuple[torch.Tensor, torch.Tensor]:
    """Both stages for the rows x: `l2_topcap`, then `_certified_least`.
    Returns (the k_pre least rows int32 [r, k_pre], ascending by (dist^2,
    row); ok [r] bool). A segment kept whole (cap = seg) loses nothing, so
    there every row is exact."""
    sel, ok = _certified_least(l2_topcap(x, t, cap, seg=seg, prepared=prepared), k_pre)
    return (sel & _MASK32).to(torch.int32), ok | (cap == seg)


def _l2_prefilter(x: torch.Tensor, t: torch.Tensor, k_pre: int) -> torch.Tensor:
    """The k_pre library rows of least squared distance per block (the JAX
    package's `_mxu_prefilter_jit`), selected exactly, the lowest rows
    first among equal distances: `_l2_least` with the plan's segment and
    cap (`_k11_topcap_plan`) in row chunks, and again with every 128-row
    segment kept whole for the rows that do not certify. Returns int32
    rows [B, k_pre] on x's device."""
    b, l = x.shape[0], t.shape[0]
    seg, cap = _k11_topcap_plan(l, k_pre)
    prepared = _k11_lib(t) if x.device.type == "cuda" else None
    out = torch.empty((b, k_pre), dtype=torch.int32, device=x.device)
    ok = torch.empty(b, dtype=torch.bool, device=x.device)
    bc = _twolevel_rows(-(-l // seg), cap)
    for b0 in range(0, b, bc):
        out[b0 : b0 + bc], ok[b0 : b0 + bc] = _l2_least(x[b0 : b0 + bc], t, k_pre, seg, cap,
                                                        prepared)
    bad = torch.nonzero(~ok)[:, 0]
    bc = _twolevel_rows(-(-l // _TL_SEG), _TL_SEG)
    for b0 in range(0, bad.numel(), bc):
        rows = bad[b0 : b0 + bc]
        out[rows] = _l2_least(x[rows], t, k_pre, _TL_SEG, _TL_SEG, prepared)[0]
    return out


def _l1_rescore(x: torch.Tensor, cand: torch.Tensor, lib: torch.Tensor, k: int):
    """Exact L1 of each block's candidates through `l1_rows` (K3 on the
    card) and their k least by (distance, row): the JAX package's
    `_l1_rescore_jit`. Its `_rescore_use_dma` test is dropped: K3 takes
    every library. Returns (dists [B, k] i32, rows [B, k] i32)."""
    cand = torch.sort(cand, dim=1).values  # ascending rows: neighbours gather together
    return _topk_rows(l1_rows(x, cand, lib), k, cand)


def l1_topk_hybrid(blocks, lib, k: int, *, k_pre: int | None = None, device=None):
    """Approximate k nearest rows: the squared-L2 prefilter (K11), then an
    exact L1 rescore on K3 (section comment above).

    Returned distances are exact int32 L1 for the returned rows, ascending
    by (distance, row); the candidate set is L2-preselected. k_pre defaults
    to max(2k, 64) capped at the library size. A small library (L <=
    max(2k, 256)) takes the exact stripes, and one over the device budget
    the exact streamed scorer. Returns host numpy int32 arrays, I32_MAX
    padded when k > L.
    """
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b = blocks.shape[0]
    l = lib.shape[0]
    if lib.numel() > DEVICE_LIB_BYTES_MAX and l > _TL_SEG:
        # the prefilter needs the whole library on the device; past the
        # budget the streamed banks give an exact candidate set instead
        return l1_topk_streamed(blocks, lib, k, device=dev)
    if l <= max(k * 2, 256):
        return l1_topk_stripes(blocks, lib, k, device=dev)
    kp = min(k_pre or max(2 * k, 64), l)
    kk = min(k, kp)
    x, t = blocks.to(dev), lib.to(dev)
    dd, rr = _l1_rescore(x, _l2_prefilter(x, t, kp), t, kk)
    return _pad_topk(_host(dd), _host(rr), b, k, kk)


def l1_argmin_hybrid(blocks, lib, *, k_pre: int = 64, device=None):
    """Approximate nearest row (the exact L1 distance of the winner) through
    `l1_topk_hybrid`. Returns host numpy (dist [B] int32, row [B] int32)."""
    d, r = l1_topk_hybrid(blocks, lib, 1, k_pre=k_pre, device=device)
    return d[:, 0], r[:, 0]


def l2_argmin(blocks, lib, *, device=None):
    """Nearest library row under squared L2 (`--metric l2`): a performance
    mode beyond the reference, which matches in L1 only.

    Returns host numpy (dist_sq [B] int32, row [B] int32): the least exact
    squared distance (wrapping past D = 33025) and the lowest row among
    equal ones, so ties may resolve differently from the L1 kernels; on
    the card, K11's argmin entry. A library whose 3x (the JAX package's u8
    + bf16 working set) exceeds the device budget streams in banks of a
    third of it through this same function, folded on (distance, lowest
    row).
    """
    dev = _device_of(blocks, device)
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    d = blocks.shape[1]
    l = lib.shape[0]
    if 3 * lib.numel() > DEVICE_LIB_BYTES_MAX and l > _TL_SEG:
        rb = max(_TL_SEG, DEVICE_LIB_BYTES_MAX // 3 // d // _TL_SEG * _TL_SEG)

        def bank_scorer(bb, ll, kx, prepared=None):
            dd_, rr_ = l2_argmin(bb, ll, device=dev)
            return dd_[:, None], rr_[:, None]

        da, ra = l1_topk_streamed(
            blocks, lib, 1, bank_rows=rb, scorer=bank_scorer, device=dev
        )
        return da[:, 0], ra[:, 0]
    dist, row = _l2_argmin(blocks.to(dev), lib.to(dev))
    return _host(dist), _host(row)
