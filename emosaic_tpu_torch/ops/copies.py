"""Host-device copies: the one route a bulk copy to the host takes, and
the uploads of host arrays.

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

Host-to-device copies: `to_device_u8` is the plain upload. `to_device_kept`
uploads a host array the caller keeps across renders (the library's
palettes, the tile stack): by the same size rule, a C-contiguous writeable
uint8 array has its own memory page-locked in place the first time it is
seen (`cuMemHostRegister`, portable, through libcuda's own API, so a
failed call leaves no error behind for torch's launch checks), and every
upload is then the plain blocking copy, which CUDA makes straight from
that memory at the link's rate. Nothing of the contents is kept: each
upload reads the array again, so a write in place shows in the next one.
A finalizer on the array unregisters the memory before the array frees
it. Anything else, and a registration that fails, takes `to_device_u8`.
Uploads add `h2d_bytes` (bytes to a device, through either function),
`h2d_pinned_bytes` (those from registered memory) and `host_registers`
(new registrations) to the open record.
"""

from __future__ import annotations

import ctypes
import math
import threading
import weakref

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


def _count_h2d(nbytes: int, pinned: bool, device: torch.device) -> None:
    """Add an upload of `nbytes` from the host to the open record's
    counters: one from registered memory, or any to a device."""
    if pinned or device.type != "cpu":
        count("h2d_bytes", nbytes)
        if pinned:
            count("h2d_pinned_bytes", nbytes)


def to_device_u8(x, device) -> torch.Tensor:
    """A uint8 array or tensor as a tensor on `device`. Read-only or
    strided host arrays (broadcast views, decoded images) are copied."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x, dtype=np.uint8)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    device = torch.device(device)
    if x.device.type == "cpu":
        _count_h2d(x.nbytes, False, device)
    return x.to(device)


class _HostPages:
    """Page-locks host memory in place through libcuda's `cu*` API (loaded
    on first use), inside the device's primary context. A failing `cu*`
    call returns its status and sets nothing that the runtime's
    `cudaGetLastError` reports later."""

    PORTABLE = 1  # CU_MEMHOSTREGISTER_PORTABLE: pinned for every context

    def __init__(self):
        self._cu = None

    def _call(self, device: torch.device, fn) -> bool:
        """fn(libcuda) == CUDA_SUCCESS with the device's primary context
        current on this thread."""
        if self._cu is None:
            try:
                self._cu = ctypes.CDLL("libcuda.so.1")
            except OSError:  # no libcuda by that name: nothing registers
                return False
        cu, dev, ctx = self._cu, ctypes.c_int(), ctypes.c_void_p()
        index = torch.cuda.current_device() if device.index is None else device.index
        if cu.cuInit(0) or cu.cuDeviceGet(ctypes.byref(dev), index):
            return False
        if cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev):
            return False
        try:
            if cu.cuCtxPushCurrent_v2(ctx):
                return False
            try:
                return fn(cu) == 0
            finally:
                cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
        finally:
            cu.cuDevicePrimaryCtxRelease_v2(dev)

    def register(self, ptr: int, nbytes: int, device: torch.device) -> bool:
        return self._call(device, lambda cu: cu.cuMemHostRegister_v2(
            ctypes.c_void_p(ptr), ctypes.c_size_t(nbytes), ctypes.c_uint(self.PORTABLE)))

    def unregister(self, ptr: int, device: torch.device) -> bool:
        return self._call(device, lambda cu: cu.cuMemHostUnregister(ctypes.c_void_p(ptr)))


_PAGES = _HostPages()
#: (address, bytes) of each registered range -> the finalizer on its owner
_REGISTERED: dict[tuple[int, int], weakref.finalize] = {}
_REGISTERED_LOCK = threading.RLock()  # a finalizer may run inside `_register`


def _owner(x):
    """The object whose lifetime bounds `x`'s memory: the outermost array
    of a NumPy view chain, or the root tensor of a torch view, also under
    an array that views a tensor (`Tensor.numpy()`)."""
    while isinstance(x, np.ndarray) and isinstance(x.base, (np.ndarray, torch.Tensor)):
        x = x.base
    while isinstance(x, torch.Tensor) and x._base is not None:
        x = x._base
    return x


def _unregister(key: tuple[int, int], device: torch.device) -> None:
    with _REGISTERED_LOCK:
        _REGISTERED.pop(key, None)
        _PAGES.unregister(key[0], device)


def _register(x, host: torch.Tensor, device: torch.device) -> bool:
    """Whether `host` (`x`'s memory) is registered page-locked, registering
    it on first sight."""
    key = (host.data_ptr(), host.nbytes)
    with _REGISTERED_LOCK:
        new = key not in _REGISTERED
        if new:
            if not _PAGES.register(*key, device):
                count("host_registers", 0)
                return False
            fin = weakref.finalize(_owner(x), _unregister, key, device)
            fin.atexit = False  # the process's exit releases its pages
            _REGISTERED[key] = fin
    count("host_registers", int(new))
    return True


def _keepable(x, device: torch.device) -> torch.Tensor | None:
    """`x` as a host tensor over its own memory where `to_device_kept` may
    register it: C-contiguous, writeable uint8, by `_page_locked`'s rule."""
    if isinstance(x, np.ndarray):
        ok = x.dtype == np.uint8 and x.flags.c_contiguous and x.flags.writeable
        host = torch.from_numpy(x) if ok else None
    elif isinstance(x, torch.Tensor):
        ok = x.device.type == "cpu" and x.dtype == torch.uint8 and x.is_contiguous()
        host = x if ok else None
    else:
        host = None
    return host if host is not None and _page_locked(device, host.nbytes) else None


def to_device_kept(x, device) -> torch.Tensor:
    """`to_device_u8` for a host uint8 array or CPU tensor the caller keeps
    across renders: uploaded from its own memory, page-locked in place on
    first sight, where `_keepable` allows."""
    device = torch.device(device)
    host = _keepable(x, device)
    if host is None or not _register(x, host, device):
        return to_device_u8(x, device)
    out = host.to(device)
    _count_h2d(host.nbytes, True, device)
    return out
