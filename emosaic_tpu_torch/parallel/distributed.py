"""Multi-process runs over `torch.distributed`.

The torch counterpart of `emosaic_tpu/parallel/distributed.py`. JAX joins
processes into one runtime whose global arrays span every process's chips;
torch has no global array. Here every process runs the same program over
the mesh positions it owns (`mesh.Mesh.local_positions`), and `exchange`
gives every process every shard's partial result (winners, top-k keys,
LUT carry planes, composite bands), after which every process folds them
alike. In one process (no process group) `exchange` is the identity. The
ring matcher's hop between processes is `sendrecv`.

Transport. The world group is gloo. CUDA partials go through an NCCL
group when every rank holds distinct GPUs, which the ranks find out at
init by exchanging `torch.cuda.get_device_properties(i).uuid`. NCCL
refuses two ranks on one GPU ("Duplicate GPU detected"), so where ranks
share a card, CUDA partials are copied to pinned host buffers, exchanged
over gloo and copied back. The route is chosen once at init and logged
once; it is not a fallback (no error is caught, no device changes), and
the compute stays on the card either way: only partial results move.

The same program runs over plain CPU processes (gloo), which is how the
tests check it (`tests/test_torch_distributed.py`).
"""

from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch

#: the CUDA route of this process, chosen at init (`_World`), or None
_WORLD = None


class _World:
    """The process group's CUDA route: "nccl" (every rank on distinct
    GPUs; `nccl` is its group), "gloo-host-staged" (ranks share a card) or
    "gloo" (no GPU visible). `exchanges` counts the collectives each route
    carried."""

    def __init__(self, route: str, nccl=None):
        self.route = route
        self.nccl = nccl
        self.exchanges = collections.Counter()


def _dist():
    import torch.distributed as dist

    return dist


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join this process into a multi-process run.

    Pass all three, or set EMOSAIC_COORDINATOR (host:port, or an init URL
    such as file:///shared/path), EMOSAIC_NUM_PROCESSES and
    EMOSAIC_PROCESS_ID. With none of them, torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT are used (`env://`), the counterpart of
    JAX's pod discovery; with neither, a process with EMOSAIC_DISTRIBUTED
    set raises, and any other stays single. A second call does nothing.
    """
    global _WORLD
    dist = _dist()
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("EMOSAIC_COORDINATOR")
    if num_processes is None and "EMOSAIC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EMOSAIC_NUM_PROCESSES"])
    if process_id is None and "EMOSAIC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EMOSAIC_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
            init_method = "env://"
            num_processes = int(os.environ["WORLD_SIZE"])
            process_id = int(os.environ["RANK"])
        elif os.environ.get("EMOSAIC_DISTRIBUTED"):
            # the user demanded a multi-process run: carrying on single
            # would make every host render the whole image on its own
            raise RuntimeError(
                "EMOSAIC_DISTRIBUTED=1 but the multi-controller runtime could "
                "not initialize (no torchrun environment / coordinator env?) — "
                "set EMOSAIC_COORDINATOR, EMOSAIC_NUM_PROCESSES, "
                "EMOSAIC_PROCESS_ID for manual clusters"
            )
        else:
            return
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed needs the coordinator, the number of processes "
                "and this process's id together"
            )
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes, rank=process_id
    )
    _WORLD = _choose_route()
    print(
        f"torch.distributed: rank {process_id} of {num_processes} ({init_method}); "
        f"CUDA partials go over {_WORLD.route}",
        file=sys.stderr,
        flush=True,
    )


def _choose_route() -> _World:
    """Compare the ranks' GPU UUIDs (a collective on the gloo group)."""
    dist = _dist()
    if not torch.cuda.is_available():
        return _World("gloo")
    mine = [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    flat = [u for part in every for u in part]
    if len(set(flat)) == len(flat):
        return _World("nccl", dist.new_group(backend="nccl"))
    return _World("gloo-host-staged")


def world() -> _World | None:
    """This process's route record, or None outside a process group."""
    return _WORLD


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    """True when this process is part of a multi-process run."""
    return world_size() > 1


def is_rank0() -> bool:
    """True in a single process and on global rank 0. The CLI lets rank 0
    alone write the outputs under EMOSAIC_DISTRIBUTED."""
    return rank() == 0


def global_cuda_devices() -> list:
    """Every process's CUDA devices, in rank order (`jax.devices()` of a
    pod): each process lists all the GPUs it sees. Raises when no GPU is
    visible; a CPU mesh is asked for with an explicit device list."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no GPU is visible: a mesh defaults to the CUDA devices; pass "
            "devices=[torch.device('cpu')] * n for a virtual CPU mesh"
        )
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = world_size()
    if n == 1:
        return local
    counts = [None] * n
    _dist().all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"the processes see different numbers of GPUs: {counts}")
    return local * n


def _route(device: torch.device) -> str:
    """The route of partials bound for `device`: gloo for the CPU, the
    init's CUDA route for a GPU."""
    global _WORLD
    if _WORLD is None:  # a process group made without init_distributed
        _WORLD = _choose_route()
    if device.type != "cuda":
        return "gloo"
    return _WORLD.route


def exchange(parts: dict, device) -> dict:
    """Every process's `parts` (key -> tensor, keys distinct across
    processes), in every process: this process's as given, the others'
    on `device`. The identity in a single process.

    One collective of metadata (keys, shapes, dtypes), then one all-gather
    of each process's parts packed as bytes, over the route for `device`.
    Every process must call it at the same point of the program.
    """
    dist = _dist()
    if not dist.is_initialized():
        return dict(parts)
    device = torch.device(device)
    route = _route(device)
    n, me = dist.get_world_size(), dist.get_rank()
    meta = [(k, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in parts.items()]
    metas = [None] * n
    dist.all_gather_object(metas, meta)
    nbytes = [
        sum(int(np.prod(s)) * getattr(torch, dt).itemsize for _, s, dt in m) for m in metas
    ]
    top = max(1, max(nbytes))
    carrier = device if route == "nccl" else torch.device("cpu")
    pinned = route == "gloo-host-staged"
    buf = torch.zeros(top, dtype=torch.uint8, device=carrier, pin_memory=pinned)
    off = 0
    for t in parts.values():
        raw = t.contiguous().view(-1).view(torch.uint8)
        buf[off : off + raw.numel()].copy_(raw)
        off += raw.numel()
    got = [torch.empty(top, dtype=torch.uint8, device=carrier, pin_memory=pinned)
           for _ in range(n)]
    dist.all_gather(got, buf, group=_WORLD.nccl if route == "nccl" else None)
    _WORLD.exchanges[route] += 1
    out = dict(parts)
    for r in range(n):
        if r == me:
            continue
        off = 0
        for k, shape, dt in metas[r]:
            dtype = getattr(torch, dt)
            size = int(np.prod(shape)) * dtype.itemsize
            raw = got[r][off : off + size]
            off += size
            out[k] = raw.view(dtype).reshape(shape).to(device)
    return out


def sendrecv(send: torch.Tensor, dst: int, src: int, device) -> torch.Tensor:
    """Send `send` to process `dst` and receive a tensor of its shape and
    dtype from process `src`, on `device` (the ring's hop between
    processes), over the route for `device`."""
    dist = _dist()
    device = torch.device(device)
    route = _route(device)
    _WORLD.exchanges[route] += 1
    if route == "nccl":
        buf = torch.empty(send.shape, dtype=send.dtype, device=device)
        ops = [dist.P2POp(dist.isend, send.contiguous(), dst, group=_WORLD.nccl),
               dist.P2POp(dist.irecv, buf, src, group=_WORLD.nccl)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf
    pinned = route == "gloo-host-staged"
    host = torch.empty(send.shape, dtype=send.dtype, pin_memory=pinned)
    host.copy_(send)
    buf = torch.empty(send.shape, dtype=send.dtype, pin_memory=pinned)
    reqs = [dist.isend(host, dst), dist.irecv(buf, src)]
    for req in reqs:
        req.wait()
    return buf.to(device)


def fetch(x) -> np.ndarray:
    """Host numpy of `x` that every process agrees on.

    A numpy array passes through. A tensor in a single process is copied
    to the host. Under a process group every process's tensor is this
    process's row slice of one array: they are gathered (`exchange`) and
    concatenated along axis 0 in rank order, like JAX's
    `process_allgather(tiled=True)`.
    """
    if isinstance(x, np.ndarray):
        return x
    dist = _dist()
    if not dist.is_initialized():
        return np.array(x.detach().cpu())
    got = exchange({dist.get_rank(): x.detach()}, x.device)
    return torch.cat([got[r].to(x.device) for r in range(dist.get_world_size())]).cpu().numpy()
