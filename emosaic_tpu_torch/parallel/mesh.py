"""Device mesh construction.

The torch counterpart of `emosaic_tpu/parallel/mesh.py`. The mosaic
workload has two natural parallel axes (SURVEY.md section 2.6):
- "data": the source-block axis, independent argmin problems (the
  reference's rayon block parallelism, rendering.rs:68-70);
- "model": the tile-library axis: each shard searches its slice of the
  library and the shards' (distance, row) winners are folded.

JAX's mesh is one controller over a process's devices, and under
`jax.distributed` over every process's. `torch.distributed`'s DeviceMesh
ties one rank to one device instead, so the port's `Mesh` is a class of
its own: a [data, model] grid of `torch.device`, and beside it the rank
of the process that owns each position. A process computes the positions
it owns (`local_positions`); `parallel.distributed.exchange` carries the
partial results between processes.
"""

from __future__ import annotations

import numpy as np
import torch

from emosaic_tpu_torch.parallel import distributed


class Mesh:
    """A ("data", "model") grid of torch devices.

    `devices` [D, M] holds a `torch.device` per position; a device may
    repeat (a virtual mesh on one card, or on the CPU). `ranks` [D, M]
    holds the process that owns each position (all 0 in one process); in
    the flattened, data-major order every process owns one contiguous run
    of positions, as `jax.devices()` lists a pod's chips process by
    process.
    """

    axis_names = ("data", "model")

    def __init__(self, devices, ranks=None):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty [data, model] grid of devices")
        devs = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                devs[i, j] = torch.device(dev)
        ranks = np.zeros(devs.shape, np.int64) if ranks is None else np.asarray(ranks)
        if ranks.shape != devs.shape:
            raise ValueError(f"ranks {ranks.shape} do not match devices {devs.shape}")
        if (np.diff(ranks.reshape(-1)) < 0).any():
            raise ValueError("each process must own one contiguous run of positions")
        self.devices = devs
        self.ranks = ranks

    @property
    def shape(self) -> dict:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, pos: int) -> torch.device:
        """The device of flattened position `pos`."""
        return self.devices.flat[pos]

    def rank(self, pos: int) -> int:
        """The process that owns flattened position `pos`."""
        return int(self.ranks.flat[pos])

    def local_positions(self) -> list[int]:
        """The flattened positions this process computes, ascending."""
        return np.flatnonzero(self.ranks.reshape(-1) == distributed.rank()).tolist()


def make_mesh(
    n_devices: int | None = None,
    model: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ("data", "model") mesh over the available devices.

    Args:
      n_devices: number of devices (default: all).
      model: library-axis shards (default: 1, pure data parallelism).
      devices: the global device list, in process order (default: every
        CUDA device of every process, `distributed.global_cuda_devices`;
        raises when no GPU is visible: the default never takes the CPU).
        A list may repeat a device: `[torch.device("cpu")] * 8` is the
        counterpart of the JAX tests' 8 virtual CPU devices, and
        `[torch.device("cuda", 0)] * 8` puts eight shards on one card.
        Under a multi-process run the list splits evenly over the
        processes in rank order.
    """
    world = distributed.world_size()
    devices = list(distributed.global_cuda_devices() if devices is None else devices)
    if not devices or len(devices) % world:
        raise ValueError(f"{len(devices)} devices do not split over {world} processes")
    per = len(devices) // world
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} available")
    model = model or 1
    if n_devices % model:
        raise ValueError(f"{n_devices} devices not divisible by model={model}")
    data = n_devices // model
    grid = [devices[r * model : (r + 1) * model] for r in range(data)]
    ranks = (np.arange(n_devices) // per).reshape(data, model)
    return Mesh(grid, ranks)
