"""The composite lab kernels: the write floor (K5), the band composite
through bulk copies (K6 one stage, K7 a two-stage ring) and the relayout of
gathered tiles (K8).

The counterparts of the TPU lab's composite probes
(`tools/tpu_r3_experiments.py`, `tpu_r3_experiments2.py`,
`tpu_r3_experiments3.py`, `tpu_bench_composite_variants.py`). Neither the
renders nor the CLI use them: the main path's composite stays K2
(`ops/composite.py`), as the JAX package's stays `_dma_kernel`. The probes
in `probes/r3_composite.py` and `probes/composite_variants.py` measure them
against K2.

Each wrapper sends a CPU tensor to its plain torch version (`*_ref`,
beside it) and a CUDA tensor to its kernel, and raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from emosaic_tpu_torch.ops._kernels import (
    BAND_TRANSPOSE,
    COMPOSE_BULK,
    COMPOSE_BULK2,
    FLOOR_WRITE,
)
from emosaic_tpu_torch.ops.composite import compose_rows_ref

#: dynamic shared memory one H100 block may use (227 KB)
SMEM_MAX = 232448
#: the kernels' bytes before the first stage (`kHeader` in compose_bulk.cu)
_HEADER = 128
#: tiles per run by default (C): the TPU's ch = 128 tiles is 512 KB of VMEM
#: at ts = 32; 16 tiles is 48 KB, so two stages of 2C still fit a block
RUN = 16


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# K5: the write floor
# ---------------------------------------------------------------------------


def floor_write_ref(seed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain torch version of K5: [h, w] u8 filled with seed[0, 0]."""
    return seed[0, 0].expand(h, w).clone()


def floor_write(seed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A [h, w] uint8 band filled with the byte seed[0, 0] of a 2-D uint8
    operand (the TPU tool's [8, 128]), read on the device: the write floor
    of a band. A CUDA tensor goes to K5 (`csrc/floor_write.cu`), a CPU
    tensor to `floor_write_ref`."""
    if seed.dtype != torch.uint8 or seed.dim() != 2 or seed.numel() == 0:
        raise ValueError(f"seed must be a non-empty 2-D uint8 tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if h < 0 or w < 0:
        raise ValueError(f"negative band shape {(h, w)}")
    if _device_kind(seed) == "cpu":
        return floor_write_ref(seed, h, w)
    out = torch.empty((h, w), dtype=torch.uint8, device=seed.device)
    if out.numel() == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("the band is not 16-byte aligned")
    FLOOR_WRITE.launch(seed.device.index, _ptr(seed), _ptr(out), h * w,
                       _stream(seed.device))
    return out


# ---------------------------------------------------------------------------
# K6 and K7: the band composite through bulk copies
# ---------------------------------------------------------------------------


def run_fit(ts: int, stages: int) -> int:
    """The most tiles per run that `stages` stages of ts-sized tiles fit in
    a block's shared memory."""
    return (SMEM_MAX - _HEADER) // (stages * ts * ts * 3)


def compose_rows_bulk_ref(items: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K6 and K7: K2's own, `compose_rows_ref` (the
    same function)."""
    return compose_rows_ref(items, aug)


def compose_rows_bulk(
    items: torch.Tensor, aug: torch.Tensor, *, stages: int = 1, run: int | None = None
) -> torch.Tensor:
    """The band of `composite.compose_rows`, items [nby, nbx] int32 and the
    augmented stack [2T+1, ts, ts*3] uint8 -> [nby*ts, nbx*ts*3] uint8,
    with the tiles staged through shared memory by bulk copies in runs of
    `run` tiles (default `RUN`, capped at what fits): `stages=1` is K6, a
    block per run; `stages=2` is K7, persistent blocks with a two-stage
    ring (`csrc/compose_bulk.cu`). A CPU tensor goes to
    `compose_rows_bulk_ref`.

    The domain is the TPU kernels': ts % 8 == 0, so that a tile is a
    16-byte multiple; a short last run takes any nbx. Outside it, or with
    a run that does not fit a block, it raises ValueError."""
    if items.dtype != torch.int32 or items.dim() != 2:
        raise TypeError(f"items must be [nby, nbx] int32, got {items.dtype}")
    if aug.dtype != torch.uint8 or aug.dim() != 3 or aug.shape[2] != 3 * aug.shape[1]:
        raise ValueError(f"aug must be [2T+1, ts, ts*3] uint8, got {tuple(aug.shape)}")
    if aug.shape[0] % 2 != 1 or aug.shape[0] < 3:
        raise ValueError(f"aug must have 2T+1 rows with T >= 1, got {aug.shape[0]}")
    if items.device != aug.device:
        raise ValueError(f"devices differ: {items.device} / {aug.device}")
    ts = aug.shape[1]
    if ts % 8:
        raise ValueError(f"bulk copies need ts % 8 == 0, got ts = {ts}")
    if stages not in (1, 2):
        raise ValueError(f"stages must be 1 or 2, got {stages}")
    fit = run_fit(ts, stages)
    run = min(RUN, fit) if run is None else run
    if run < 1 or run > fit:
        raise ValueError(f"a run of {run} tiles at ts = {ts} in {stages} stage(s) does "
                         f"not fit {SMEM_MAX} bytes of shared memory (at most {fit})")
    if items.shape[1] * aug.shape[2] >= 2**31:
        raise ValueError("band row wider than 2^31 bytes")
    if _device_kind(items) == "cpu":
        return compose_rows_bulk_ref(items, aug)
    items, aug = items.contiguous(), aug.contiguous()
    nby, nbx = items.shape
    out = torch.empty((nby * ts, nbx * ts * 3), dtype=torch.uint8, device=aug.device)
    if out.numel() == 0:
        return out
    if aug.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("bulk copies need 16-byte aligned aug and band")
    kernel = COMPOSE_BULK if stages == 1 else COMPOSE_BULK2
    kernel.launch(aug.device.index, _ptr(items), _ptr(aug), _ptr(out),
                  aug.shape[0] // 2, nby, nbx, ts, run, _stream(aug.device))
    return out


# ---------------------------------------------------------------------------
# K8: the relayout of gathered tiles
# ---------------------------------------------------------------------------


def band_transpose_ref(sel: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Plain torch version of K8: a permuting reshape."""
    ts, w = sel.shape[1], sel.shape[2]
    return sel.view(nby, nbx, ts, w).permute(0, 2, 1, 3).reshape(nby * ts, nbx * w)


def band_transpose(sel: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Gathered tiles sel [nby*nbx, ts, w] uint8 (row-major block order) ->
    the band [nby*ts, nbx*w] uint8. A CUDA tensor goes to K8
    (`csrc/band_transpose.cu`), a CPU tensor to `band_transpose_ref`."""
    if sel.dtype != torch.uint8 or sel.dim() != 3:
        raise ValueError(f"sel must be [nby*nbx, ts, w] uint8, got {sel.dtype} "
                         f"{tuple(sel.shape)}")
    if nby < 0 or nbx < 0 or sel.shape[0] != nby * nbx:
        raise ValueError(f"sel has {sel.shape[0]} tiles, not {nby} x {nbx}")
    ts, w = sel.shape[1], sel.shape[2]
    if nbx * w >= 2**31 or nby * ts >= 2**31:
        raise ValueError("band wider or taller than 2^31")
    if _device_kind(sel) == "cpu":
        return band_transpose_ref(sel, nby, nbx)
    sel = sel.contiguous()
    out = torch.empty((nby * ts, nbx * w), dtype=torch.uint8, device=sel.device)
    if out.numel() == 0:
        return out
    BAND_TRANSPOSE.launch(sel.device.index, _ptr(sel), _ptr(out), nby, nbx, ts, w,
                          _stream(sel.device))
    return out
