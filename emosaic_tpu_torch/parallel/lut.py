"""Multi-device build of the exact L1 nearest-tile LUT (mode 1).

The torch counterpart of `emosaic_tpu/parallel/lut.py`: the 256^3 RGB
lattice of `ops.lut.build_l1_lut` split over the flattened mesh along its
b (outermost) axis. Each 1D min-plus transform d[i] = min_j f[j] + |i-j|
is a forward and a backward scan,

    fwd[i] = min_{j<=i} (f[j] - j*u) + i*u
    bwd[i] = min_{j>=i} (f[j] + j*u) - i*u
    d[i]   = min(fwd[i], bwd[i])        (u = 1 << ROW_BITS)

so each scan is a `torch.cummin` over position-adjusted packed keys (the
backward one on `flip`). The g and r axes are local to a shard; the b axis
is a parallel prefix: a local scan, the other shards' carry planes (one
`exchange` for both directions, 256 KB per shard each) and a
lexicographic fold. Keys pack (distance, row) as in `ops/lut.py`, so the
result is bit-identical to `build_l1_lut`, lowest-row ties included.
"""

from __future__ import annotations

import numpy as np
import torch

from emosaic_tpu_torch.ops.distance import _host
from emosaic_tpu_torch.ops.lut import _INF, MAX_ROWS, ROW_BITS, pack_rgb
from emosaic_tpu_torch.parallel.distributed import exchange
from emosaic_tpu_torch.parallel.mesh import Mesh

_U = 1 << ROW_BITS


def _adj(lat: torch.Tensor, delta: torch.Tensor, sign: int) -> torch.Tensor:
    """Position-adjust packed keys, keeping the INF sentinel exact. Real
    keys stay below INF: the largest is 765 << 21 + row < 1.61e9 and
    |delta| <= 255 << 21 = 5.35e8, so key +- delta fits int32 (the INF
    lanes may wrap, and are replaced)."""
    return torch.where(lat == _INF, _INF, lat + sign * delta)


def _cummin(x: torch.Tensor, axis: int, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return x.flip(axis).cummin(axis).values.flip(axis)
    return x.cummin(axis).values


def _axis_transform_local(lat: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 1D min-plus transform along a whole (unsplit) 256 axis."""
    shape = [1, 1, 1]
    shape[axis] = lat.shape[axis]
    pos = (torch.arange(lat.shape[axis], dtype=torch.int32, device=lat.device) * _U).view(shape)
    fwd = _adj(_cummin(_adj(lat, pos, -1), axis), pos, +1)
    bwd = _adj(_cummin(_adj(lat, pos, +1), axis, reverse=True), pos, -1)
    return torch.minimum(fwd, bwd)


def _slab(lib: np.ndarray, lo: int, s: int, dev) -> torch.Tensor:
    """The [s, 256, 256] lattice slab of b in [lo, lo + s): each colour's
    lowest row (a host dedup; rows ascend), INF elsewhere."""
    idx = pack_rgb(lib)
    uniq, first = np.unique(idx, return_index=True)
    mine = (uniq >= lo * 65536) & (uniq < (lo + s) * 65536)
    slab = torch.full((s * 65536,), _INF, dtype=torch.int32, device=dev)
    slab[torch.as_tensor(uniq[mine] - lo * 65536, device=dev)] = torch.as_tensor(
        first[mine].astype(np.int32), device=dev)
    return slab.view(s, 256, 256)


def sharded_build_l1_lut(lib, mesh: Mesh) -> np.ndarray:
    """Build the [256, 256, 256] packed (dist, row) LUT over the mesh.

    Bit-identical to `ops.lut.build_l1_lut` (tests/test_torch_parallel.py).
    Uses the flattened mesh as one axis; 256 must divide by its size.

    Args:
      lib: [L, 3] uint8 mode-1 library matrix (host array or tensor).
    Returns:
      [256, 256, 256] int32 lattice (host numpy).
    """
    if isinstance(lib, torch.Tensor):
        lib = lib.cpu().numpy()
    lib = np.ascontiguousarray(lib, dtype=np.uint8)
    if lib.ndim != 2 or lib.shape[1] != 3:
        raise ValueError(f"LUT requires [L,3] mode-1 library, got {lib.shape}")
    if not 0 < lib.shape[0] <= MAX_ROWS:
        raise ValueError(f"library size {lib.shape[0]} out of range")
    n = mesh.size
    if 256 % n:
        raise ValueError(f"lattice axis 256 not divisible by {n} devices")
    s = 256 // n
    own = mesh.local_positions()
    home = mesh.device(own[0])
    fwd, bwd, pos_g = {}, {}, {}
    for p in own:
        dev = mesh.device(p)
        lat = _slab(lib, p * s, s, dev)
        lat = _axis_transform_local(lat, 1)  # g
        lat = _axis_transform_local(lat, 2)  # r
        # b: this shard's planes are global positions p*s .. p*s + s - 1
        pos_g[p] = ((p * s + torch.arange(s, dtype=torch.int32, device=dev)) * _U).view(s, 1, 1)
        fwd[p] = _cummin(_adj(lat, pos_g[p], -1), 0)  # min over j <= i of f[j] - j u
        bwd[p] = _cummin(_adj(lat, pos_g[p], +1), 0, reverse=True)  # j >= i: f[j] + j u
    carries = exchange(
        {**{(p, "f"): fwd[p][-1] for p in own}, **{(p, "b"): bwd[p][0] for p in own}}, home)
    slabs = {}
    for p in own:
        dev = mesh.device(p)
        inf = torch.full((256, 256), _INF, dtype=torch.int32, device=dev)
        prefix, suffix = inf, inf
        for q in range(n):
            if q < p:
                prefix = torch.minimum(prefix, carries[(q, "f")].to(dev))
            elif q > p:
                suffix = torch.minimum(suffix, carries[(q, "b")].to(dev))
        f = _adj(torch.minimum(fwd[p], prefix), pos_g[p], +1)
        b = _adj(torch.minimum(bwd[p], suffix), pos_g[p], -1)
        slabs[p] = torch.minimum(f, b)
    slabs = exchange(slabs, home)
    return _host(torch.cat([slabs[p].to(home) for p in range(n)]))
