"""Mosaic composition (tile gather + layout) and the bit-exact tint blend.

The torch counterpart of `emosaic_tpu/ops/composite.py`. Negative item ids
select the mirrored tile image; the augmented stack holds
[originals; mirrored copies; one black row], so flips and unassigned
blocks (item 0) are plain row selection.

`compose_rows` writes one band. On a CUDA tensor it launches the
hand-written kernel `csrc/compose.cu`; on a CPU tensor it runs
`compose_rows_ref`, its plain torch version. TPU-only devices of the JAX
package that this port drops, one line each:

- 128-lane row padding (`_lane`): a TPU DMA slice rule; rows here are
  exactly ts*3 bytes.
- row-chunking per call (`_DMA_MAX_ROWS`): a TPU scalar-prefetch (SMEM)
  budget; the CUDA kernel reads its items from device memory.
- the `[rows, width*3]` boundary rule: a TPU tiled-layout inflation of
  size-3 minor dims; torch tensors have no tiled layout.
- the 4 GiB stack limit (`_DMA_STACK_BYTES_MAX`): TPU DMA offsets wrap at
  2^32; the CUDA kernel uses 64-bit byte offsets.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator

import numpy as np
import torch

from emosaic_tpu_torch.monitor import span
from emosaic_tpu_torch.ops._kernels import COMPOSE
from emosaic_tpu_torch.ops.copies import to_device_kept, to_device_u8, to_host


def augment_stack2d(stack, *, device) -> tuple[torch.Tensor, int]:
    """[T, ts, ts, 3] uint8 -> [2T+1, ts, ts*3] uint8 on `device`:
    originals, mirrored copies, and a black row for unassigned blocks.
    The caller keeps `stack` across renders (`to_device_kept`)."""
    stack = to_device_kept(stack, device)
    if stack.dim() != 4 or stack.shape[3] != 3:
        raise ValueError(f"expected [T,ts,ts,3] uint8, got {tuple(stack.shape)}")
    t, ts = stack.shape[0], stack.shape[1]
    aug = torch.empty((2 * t + 1, ts, ts * 3), dtype=torch.uint8, device=device)
    aug[:t] = stack.reshape(t, ts, ts * 3)
    aug[t : 2 * t] = stack.flip(2).reshape(t, ts, ts * 3)
    aug[2 * t] = 0
    return aug, ts


def rows_of(items: torch.Tensor, t: int) -> torch.Tensor:
    """Signed items -> augmented-stack rows (int64): +i -> i-1,
    -i -> T+i-1, clipped to [0, 2T-1]; 0 -> the black row 2T."""
    flat = items.reshape(-1).to(torch.int64)
    rows = torch.where(flat >= 0, flat - 1, t - flat - 1).clamp(0, 2 * t - 1)
    return torch.where(flat == 0, 2 * t, rows)


def compose_rows_ref(items: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2: items [nby, nbx] i32, aug [2T+1, ts, ts*3]
    u8 -> band [nby*ts, nbx*ts*3] u8 (`index_select` and reshape)."""
    nby, nbx = items.shape
    ts, s3 = aug.shape[1], aug.shape[2]
    sel = aug.index_select(0, rows_of(items, aug.shape[0] // 2))
    band = sel.reshape(nby, nbx, ts, s3).permute(0, 2, 1, 3)
    return band.reshape(nby * ts, nbx * s3)


def _compose_rows_cuda(items: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    nby, nbx = items.shape
    ts, s3 = aug.shape[1], aug.shape[2]
    out = torch.empty((nby * ts, nbx * s3), dtype=torch.uint8, device=aug.device)
    if out.numel() == 0:
        return out
    vec16 = s3 % 16 == 0 and aug.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(aug.device).cuda_stream
    COMPOSE.launch(
        aug.device.index,
        ctypes.c_void_p(items.data_ptr()),
        ctypes.c_void_p(aug.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        aug.shape[0] // 2,
        nby,
        nbx,
        ts,
        int(vec16),
        ctypes.c_void_p(stream),
    )
    return out


def compose_rows(items: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """One band of the mosaic: items [nby, nbx] int32 signed 1-based ids
    and the augmented stack [2T+1, ts, ts*3] uint8 (`augment_stack2d`) ->
    [nby*ts, nbx*ts*3] uint8 on their device.

    A CUDA tensor goes to K2 (`csrc/compose.cu`), a CPU tensor to
    `compose_rows_ref`."""
    if items.dtype != torch.int32 or items.dim() != 2:
        raise TypeError(f"items must be [nby, nbx] int32, got {items.dtype}")
    if aug.dtype != torch.uint8 or aug.dim() != 3 or aug.shape[2] != 3 * aug.shape[1]:
        raise ValueError(f"aug must be [2T+1, ts, ts*3] uint8, got {tuple(aug.shape)}")
    if aug.shape[0] % 2 != 1 or aug.shape[0] < 3:
        raise ValueError(f"aug must have 2T+1 rows with T >= 1, got {aug.shape[0]}")
    if items.device != aug.device:
        raise ValueError(f"devices differ: {items.device} / {aug.device}")
    if items.shape[1] * aug.shape[2] >= 2**31:
        raise ValueError("band row wider than 2^31 bytes")
    if items.device.type == "cpu":
        return compose_rows_ref(items, aug)
    if items.device.type != "cuda":
        raise ValueError(f"unsupported device {items.device}")
    return _compose_rows_cuda(items.contiguous(), aug.contiguous())


def _band_tensors(items: np.ndarray, aug: torch.Tensor, band_rows: int):
    """Yield the mosaic's bands of `band_rows` block-rows as device tensors
    [h, W*3]."""
    for y0 in range(0, items.shape[0], band_rows):
        part = torch.as_tensor(items[y0 : y0 + band_rows], device=aug.device)
        yield compose_rows(part, aug)


def compose_mosaic(items, stack, *, device) -> np.ndarray:
    """Assemble the mosaic from signed tile selections.

    items: [nby, nbx] int32 signed 1-based ids (negative = flipped, 0 =
    black); stack: [T, ts, ts, 3] uint8 prepared tile images. Returns the
    [nby*ts, nbx*ts, 3] uint8 mosaic on the host. The stack's way to the
    device (`augment_stack2d`) is the span `compose.stack`."""
    items = np.ascontiguousarray(items, dtype=np.int32)
    with span("compose.stack"):
        aug, ts = augment_stack2d(stack, device=device)
    nby, nbx = items.shape
    band = compose_rows(torch.as_tensor(items, device=aug.device), aug)
    return to_host(band).reshape(nby * ts, nbx * ts, 3)


def iter_bands(items, stack, band_rows: int = 8, *, device) -> Iterator[np.ndarray]:
    """Stream the mosaic as host bands [band_rows*ts, nbx*ts, 3] uint8."""
    items = np.ascontiguousarray(items, dtype=np.int32)
    aug, ts = augment_stack2d(stack, device=device)
    for band in _band_tensors(items, aug, band_rows):
        yield to_host(band).reshape(band.shape[0], -1, 3)


def iter_bands_host(
    items, tile_set, tile_size: int, band_rows: int = 4, cache_tiles: int = 4096
) -> Iterator[np.ndarray]:
    """Host-side banded composite for stacks too large for memory: tile
    images stream from the prepared-tile disk cache through an LRU, flips
    applied per placement (tileset.rs:146-161)."""
    items = np.asarray(items, dtype=np.int32)
    nby, nbx = items.shape

    @functools.lru_cache(maxsize=cache_tiles)
    def tile_img(idx: int) -> np.ndarray:
        from emosaic_tpu_torch.io.prep import prepare_tile

        return prepare_tile(tile_set.get_path(idx), tile_size, crop=True)

    for y0 in range(0, nby, band_rows):
        rows = items[y0 : y0 + band_rows]
        band = np.zeros(
            (rows.shape[0] * tile_size, nbx * tile_size, 3), dtype=np.uint8
        )
        for by in range(rows.shape[0]):
            for bx in range(nbx):
                it = int(rows[by, bx])
                if it == 0:
                    continue
                img = tile_img(abs(it))
                if it < 0:
                    img = img[:, ::-1, :]
                band[
                    by * tile_size : (by + 1) * tile_size,
                    bx * tile_size : (bx + 1) * tile_size,
                ] = img
        yield band


# ---------------------------------------------------------------------------
# tint blending (reference main.rs:447-478)
# ---------------------------------------------------------------------------


def tint_scalars(alpha_255: int) -> np.ndarray:
    """The per-call f32 scalars of image-0.25.2's `Rgba::blend`, computed
    with numpy f32 (one rounding per op). Returns
    [max_t, fg_a, 1-fg_a, alpha_final]; alpha_final is 1.0 for 224 of the
    256 alphas and 1-2^-24 for the rest."""
    mt = np.float32(255.0)
    one = np.float32(1.0)
    fg_a = np.float32(np.float32(alpha_255) / mt)
    af = np.float32(np.float32(one + fg_a) - np.float32(one * fg_a))
    return np.array([mt, fg_a, np.float32(one - fg_a), af], np.float32)


def ref_tint_blend_u8(bg_u8, fg_u8, alpha_255: int) -> np.ndarray:
    """Scalar port of the reference tint compositing, the bit-exact oracle:
    normalize to f32, src-over with an opaque background, unmultiply by
    alpha_final, then a TRUNCATING cast of 255*out (main.rs:447-478)."""
    mt, fg_a, inv, af = tint_scalars(alpha_255)
    one = np.float32(1.0)
    bg_r = np.float32(np.asarray(bg_u8, np.uint8).astype(np.float32) / mt)
    fg_r = np.float32(np.asarray(fg_u8, np.uint8).astype(np.float32) / mt)
    t = np.float32(
        np.float32(fg_r * fg_a) + np.float32(np.float32(bg_r * one) * inv)
    )
    u = np.float32(t / af)
    return np.trunc(np.float32(mt * u)).astype(np.uint8)


def _u8_over_255_f32(x_u8: torch.Tensor) -> torch.Tensor:
    """fl32(x / 255) for u8 x without a division: x/255 = p / (2^32 - 1)
    with p = x * 16843009, rounded to f32 (RNE), with a +1 nudge that
    breaks the conversion ties upward (x = 0 and 255 excluded), then an
    exact 2^-32 scale. p is int64: torch's uint32 support is partial."""
    p = x_u8.to(torch.int64) * 16843009
    nudge = ((x_u8 > 0) & (x_u8 < 255)).to(torch.int64)
    return (p + nudge).to(torch.float32) * (2.0**-32)


def _tint_sample_indices(bh, ow, sh, sw, out_h, y0):
    """Nearest-neighbor sample grid at output-pixel centers, like
    image::imageops::resize(FilterType::Nearest) (main.rs:456-461), in
    float32 op for op (f64 would pick other rows near rounding edges)."""
    yr = np.float32(sh / out_h)
    yi = np.clip(
        (
            (np.arange(y0, y0 + bh, dtype=np.int32).astype(np.float32)
             + np.float32(0.5))
            * yr
        ).astype(np.int32),
        0,
        sh - 1,
    )
    xr = np.float32(sw / ow)
    xi = np.clip(
        (
            (np.arange(ow, dtype=np.int32).astype(np.float32)
             + np.float32(0.5))
            * xr
        ).astype(np.int32),
        0,
        sw - 1,
    )
    xi3 = (xi[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
    return yi.astype(np.int32), xi3.astype(np.int32)


def _tint_blend_2d(band2d, src2d, scal, yi, xi3, *, bump: bool) -> torch.Tensor:
    """band2d [bh, ow*3] u8, src2d [sh, sw*3] u8 -> blended [bh, ow*3] u8,
    bit-exact to `ref_tint_blend_u8`. Each torch op rounds to f32 once, so
    no multiply is contracted into an FMA; x/255 uses the division-free
    form; with alpha_final = 1-2^-24 (`bump`) the final division equals a
    one-ulp bit increment of every reachable nonzero sum."""
    up = src2d.index_select(0, yi.to(torch.int64)).index_select(1, xi3.to(torch.int64))
    mt, fg_a, inv = float(scal[0]), float(scal[1]), float(scal[2])
    fg_r = _u8_over_255_f32(up)
    bg_r = _u8_over_255_f32(band2d)
    prod_fg = fg_r * fg_a
    prod_bg = (bg_r * 1.0) * inv
    t = prod_fg + prod_bg
    if bump:
        t_up = (t.view(torch.int32) + 1).view(torch.float32)
        t = torch.where(t == 0, t, t_up)
    return torch.clamp(torch.trunc(mt * t), 0, 255).to(torch.uint8)


def _tint_band_tensor(band2d, src2d, y0: int, out_h: int, alpha: int) -> torch.Tensor:
    """Tint one band already on the device; `src2d` is [sh, sw*3] u8 there."""
    bh, ow = band2d.shape[0], band2d.shape[1] // 3
    scal = tint_scalars(alpha)
    yi, xi3 = _tint_sample_indices(
        bh, ow, src2d.shape[0], src2d.shape[1] // 3, out_h, y0
    )
    dev = band2d.device
    return _tint_blend_2d(
        band2d,
        src2d,
        scal,
        torch.as_tensor(yi, device=dev),
        torch.as_tensor(xi3, device=dev),
        bump=bool(scal[3] != np.float32(1.0)),
    )


def _alpha(tint_opacity: float) -> int:
    return int(255.0 * float(tint_opacity))


def tint_blend_band(band, src, y0: int, out_h: int, tint_opacity: float, *, device):
    """Per-band tint blend for the streamed path: the math of `tint_blend`
    applied to output rows [y0, y0+h). Returns host [h, W, 3] uint8."""
    alpha = _alpha(tint_opacity)
    band = np.asarray(band, dtype=np.uint8)
    if alpha <= 0:
        return band  # the blend with fg_a = 0 is the identity
    bh = band.shape[0]
    src = np.asarray(src, dtype=np.uint8)
    out = _tint_band_tensor(
        to_device_u8(band, device).reshape(bh, -1),
        to_device_u8(src, device).reshape(src.shape[0], -1),
        y0,
        out_h,
        alpha,
    )
    return to_host(out).reshape(band.shape)


def stream_tinted_bands(
    items,
    tile_set,
    stack,
    tile_size: int,
    *,
    original_rgb=None,
    tint_opacity: float = 0.0,
    band_budget: int = 256 << 20,
    device,
):
    """Compose the mosaic as bands (device path when `stack` is given,
    host-LRU path otherwise), tint-blending each band when asked. Yields
    host [h, W, 3] u8 bands top to bottom. On the device path a band is
    composed and tinted on `device` and crosses to the host once."""
    items = np.ascontiguousarray(items, dtype=np.int32)
    nby, nbx = items.shape
    out_h = nby * tile_size
    band_rows = max(1, band_budget // (nbx * tile_size**2 * 3))
    alpha = _alpha(tint_opacity) if original_rgb is not None else 0
    if stack is None:
        y0 = 0
        for band in iter_bands_host(items, tile_set, tile_size, band_rows=band_rows):
            if alpha > 0:
                band = tint_blend_band(
                    band, original_rgb, y0, out_h, tint_opacity, device=device
                )
            y0 += band.shape[0]
            yield band
        return
    aug, _ = augment_stack2d(stack, device=device)
    src2d = None
    if alpha > 0:
        src = np.asarray(original_rgb, dtype=np.uint8)
        src2d = to_device_u8(src, device).reshape(src.shape[0], -1)
    y0 = 0
    for band in _band_tensors(items, aug, band_rows):
        if src2d is not None:
            band = _tint_band_tensor(band, src2d, y0, out_h, alpha)
        y0 += band.shape[0]
        yield to_host(band).reshape(band.shape[0], -1, 3)


def tint_blend(mosaic, src, tint_opacity: float, *, device) -> np.ndarray:
    """Alpha-composite the source image over the mosaic (main.rs:447-465):
    alpha = floor(255 * opacity), source nearest-upscaled to the output,
    `Rgba::blend` src-over an opaque background, truncating final cast."""
    mosaic = np.asarray(mosaic, dtype=np.uint8)
    return tint_blend_band(mosaic, src, 0, mosaic.shape[0], tint_opacity, device=device)
