"""Device-to-host copies: the one route a bulk copy to the host takes.

A copy of a CUDA tensor of `PINNED_MIN_BYTES` or more lands in page-locked
host memory from torch's caching host allocator: `copy_(...,
non_blocking=True)`, then one sync of the device's current stream, and the
host array handed on is a zero-copy NumPy view of that memory. A fresh
pageable array would fault in each of its pages while CUDA copies
into it, at a few GB/s; the cached page-locked block is copied into at the
link's rate and is allocated once, not once a render.

Lifetime: the NumPy view holds the block's tensor, and the allocator hands
a block out again only once that tensor is freed (and the copy's stream
has passed it), so an array the caller keeps (a render's image, its
lists, its host library) never sees a later copy's bytes.

CPU tensors and copies under `PINNED_MIN_BYTES` keep `.cpu().numpy()`.

Each copy of a device tensor adds to the record of the render open in this
context (`monitor.record`): `d2h_bytes` (bytes copied to the host),
`d2h_pinned_bytes` (those that landed page-locked) and, where the
installed torch reports its host allocator, `host_pin_allocs` (new
page-locked blocks the copies allocated).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from emosaic_tpu_torch.monitor import count

#: the least copy that lands page-locked; under it `.cpu()` is as fast
#: (`probes/d2h.py`'s crossover on an H100, PERF.md §6)
PINNED_MIN_BYTES = 256 << 10


def _page_locked(device: torch.device, nbytes: int) -> bool:
    """Whether a copy of `nbytes` from `device` lands page-locked."""
    return device.type == "cuda" and nbytes >= PINNED_MIN_BYTES


def _host_allocs() -> int | None:
    """Blocks torch's caching host allocator has allocated so far, where
    the installed torch reports it (the nested form: the flat one costs
    tens of microseconds a call)."""
    stats = getattr(torch.cuda, "host_memory_stats_as_nested_dict", None)
    return None if stats is None else stats().get("num_host_alloc", 0)


def _pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """A page-locked host tensor from torch's caching host allocator,
    counting the blocks it had to allocate anew."""
    before = _host_allocs()
    buf = torch.empty(shape, dtype=dtype, pin_memory=True)
    if before is not None:
        count("host_pin_allocs", _host_allocs() - before)
    return buf


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _count(x: torch.Tensor, pinned: bool) -> None:
    """Add a copy of `x` to the open record's counters: one that landed
    page-locked, or any off a device."""
    if pinned or x.device.type != "cpu":
        nbytes = x.numel() * x.element_size()
        count("d2h_bytes", nbytes)
        if pinned:
            count("d2h_pinned_bytes", nbytes)


def to_host(x: torch.Tensor) -> np.ndarray:
    """`x` as a host NumPy array: a view of `x` on the CPU, else its copy,
    page-locked where `_page_locked` says so."""
    if not _page_locked(x.device, x.numel() * x.element_size()):
        _count(x, False)
        return x.cpu().numpy()
    buf = _pinned_empty(x.shape, x.dtype)
    buf.copy_(x, non_blocking=True)
    _sync(x.device)
    _count(x, True)
    return buf.numpy()


class Assembly:
    """Host arrays assembled from slices copied off `device`, each slice
    straight into its place: `empty` makes an array (page-locked by the
    rule of `to_host`, on its whole size), `put` copies a device slice into
    a slice of it, and `wait` syncs the device's stream once, before the
    arrays are read."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned: set[int] = set()

    def empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        if not _page_locked(self.device, math.prod(shape) * dtype.itemsize):
            return torch.empty(shape, dtype=dtype)
        buf = _pinned_empty(shape, dtype)
        self._pinned.add(buf.untyped_storage().data_ptr())
        return buf

    def put(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        pinned = dst.untyped_storage().data_ptr() in self._pinned
        dst.copy_(src, non_blocking=pinned)
        _count(src, pinned)

    def wait(self) -> None:
        if self._pinned:
            _sync(self.device)
