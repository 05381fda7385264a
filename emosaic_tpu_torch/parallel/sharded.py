"""Sharded matching and composition over a ("data", "model") mesh.

The torch counterpart of `emosaic_tpu/parallel/sharded.py`, with its
contract: uint8 arrays (or tensors) in, host numpy out, bit-identical to
the single-device routes, the lowest-row tie-break included.

- Source blocks split over "data", the library over "model". Each shard
  runs the port's own kernel on its slice (K1 `l1_argmin`; the stripe
  top-k; the adaptive scorer's K9 coarse pass and K3 rescore), its
  results take global row numbers, and the shards fold in (distance,
  global row) order: an associative combine.
- Padding rows are copies of row 0 (of the blocks, of the library) at
  higher indices, so a padded library row never wins a tie against the
  row it copies, and padded blocks are cut off.
- Each process computes the mesh positions it owns, then
  `distributed.exchange` gives every process every shard's partial
  result (the identity in one process) and every process folds them
  alike, so all return the same arrays.
- Within a process the shards' device work is enqueued with no host sync
  up to the fold (no `.cpu()`, `.item()` or `_host()` in the per-shard
  loops), so a process with several cards overlaps its shards. Only one
  card has been available to measure: this is a design rule, not a
  measured speed.

Not ported: `_stripe_f32_ok` and the f32/i32 stripe choice (a v5e
lane-rate fact; the port's `l1_block` is exact either way), and the jit
caches (torch runs eagerly).
"""

from __future__ import annotations

import numpy as np
import torch

from emosaic_tpu_torch.ops import distance as dd
from emosaic_tpu_torch.ops.analysis import analyse_batch, source_blocks
from emosaic_tpu_torch.ops.composite import augment_stack2d, compose_rows
from emosaic_tpu_torch.ops.distance import I32_MAX, _as_u8, _host
from emosaic_tpu_torch.parallel.distributed import exchange, rank, sendrecv
from emosaic_tpu_torch.parallel.mesh import Mesh


def _pad_rows_with_first(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad axis 0 to a multiple by repeating row 0 (tie-safe padding)."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    return torch.cat([x, x[:1].expand(target - n, *x.shape[1:])])


def _pad_prepare(multiple: int, device=None):
    """Streamed-scorer `prepare` for the library-sharding routes: the pad
    they perform internally, and the upload to `device` (default: stay
    where the slice is), so `l1_topk_streamed`'s worker thread overlaps the
    next bank's transfer with the current bank's scoring. Handle:
    (padded_lib, rows). b and k belong to the prepare protocol (scorers
    with fallback routes decline ineligible banks); these routes take
    every handle."""

    def prepare(lib_slice, d, b=None, k=None):
        lib_slice = _as_u8(lib_slice)
        lib_p = _pad_rows_with_first(lib_slice, multiple)
        return (lib_p if device is None else lib_p.to(device)), lib_slice.shape[0]

    return prepare


def _check_pad_prepared(prepared, l: int, d: int, multiple: int) -> torch.Tensor:
    """Shape-check a `_pad_prepare` handle against THIS library (a
    mismatched handle would silently score the wrong rows)."""
    lib_p, rows = prepared
    target = -(-l // multiple) * multiple
    if rows != l or tuple(lib_p.shape) != (target, d):
        raise ValueError(
            f"prepared library covers {rows} rows, shape "
            f"{tuple(lib_p.shape)}; this call needs {l} rows, shape "
            f"({target}, {d})"
        )
    return lib_p


def _argmin_bank_scorer(kernel, mesh: Mesh, multiple: int):
    """The streamed route's bank scorer for the argmin routes: the
    (dist, row) pair as the streamer's top-1 columns, with the padded
    upload as its `prepare` hook."""

    def bank_scorer(bb, ll, kx, prepared=None):
        d_, r_ = kernel(bb, ll, mesh, prepared=prepared)
        return d_[:, None], r_[:, None]

    bank_scorer.prepare = _pad_prepare(multiple, _home(mesh))
    return bank_scorer


def _home(mesh: Mesh) -> torch.device:
    """This process's first device: where the shards fold."""
    return mesh.device(mesh.local_positions()[0])


class _Slices:
    """Equal row slices of one tensor, each moved to a device once: on a
    virtual mesh several positions share a device and read one slice."""

    def __init__(self, x: torch.Tensor, rows: int):
        self.x, self.rows, self.got = x, rows, {}

    def __call__(self, i: int, dev: torch.device) -> torch.Tensor:
        key = (i, dev)
        if key not in self.got:
            self.got[key] = self.x[i * self.rows : (i + 1) * self.rows].to(dev)
        return self.got[key]


def _fold_argmin(parts: dict, n_data: int, n_model: int, dev) -> tuple:
    """Fold each data slice's [2, rows] (distance, global row) shards over
    "model", lexicographically, and join the slices: (dist, row) on dev."""
    out = []
    for i in range(n_data):
        best = parts[i * n_model].to(dev)
        for m in range(1, n_model):
            cur = parts[i * n_model + m].to(dev)
            take = (cur[0] < best[0]) | ((cur[0] == best[0]) & (cur[1] < best[1]))
            best = torch.where(take, cur, best)
        out.append(best)
    both = torch.cat(out, dim=1)
    return both[0], both[1]


def sharded_l1_argmin(blocks, lib, mesh: Mesh, *, prepared=None):
    """Exact L1 nearest library row, sharded over a ("data", "model") mesh.

    Same contract and results as `ops.distance.l1_argmin`, as host numpy
    (dist [B] int32, row [B] int32). blocks: [B, D] uint8; lib: [L, D]
    uint8. Each shard runs K1 (`l1_argmin`) on its slice. A library whose
    per-"model" shard exceeds the device budget streams host banks through
    this same route; `prepared` is the streamer's `_pad_prepare` handle
    for THIS lib.
    """
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    home = _home(mesh)
    if lib.numel() // n_model > dd.DEVICE_LIB_BYTES_MAX and l > dd._TL_SEG:
        da, ra = dd.l1_topk_streamed(
            blocks, lib, 1, device=home,
            scorer=_argmin_bank_scorer(sharded_l1_argmin, mesh, n_model),
        )
        return da[:, 0], ra[:, 0]
    blocks_p = _pad_rows_with_first(blocks, n_data)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, l, blocks.shape[1], n_model)
    else:
        lib_p = _pad_rows_with_first(lib, n_model)
    ls = lib_p.shape[0] // n_model
    xs, ts = _Slices(blocks_p, blocks_p.shape[0] // n_data), _Slices(lib_p, ls)
    local = {}
    for pos in mesh.local_positions():
        i, m = divmod(pos, n_model)
        dev = mesh.device(pos)
        dist, row = dd.l1_argmin(xs(i, dev), ts(m, dev))
        local[pos] = torch.stack([dist, row + m * ls])
    dist, row = _fold_argmin(exchange(local, home), n_data, n_model, home)
    return _host(dist)[:b], _host(row)[:b]


def _ring_pass(slabs: dict, mesh: Mesh) -> dict:
    """One hop of the ring: position p receives position p-1's slab. Within
    a process a `.to()`; between processes each process's last slab goes
    to the next process's first position (`distributed.sendrecv`)."""
    n = mesh.size
    own = mesh.local_positions()
    out = {}
    nxt, prv = mesh.rank((own[-1] + 1) % n), mesh.rank((own[0] - 1) % n)
    if nxt != rank():
        out[own[0]] = sendrecv(slabs[own[-1]], nxt, prv, mesh.device(own[0]))
    for p in own:
        src = (p - 1) % n
        if src in slabs:
            out[p] = slabs[src].to(mesh.device(p))
    return out


def sharded_l1_argmin_ring(blocks, lib, mesh: Mesh, *, prepared=None):
    """Exact L1 argmin with ring rotation of library shards (the
    sequence-parallel analogue of SURVEY §2.6): blocks stay resident per
    shard, library slabs rotate around the flattened mesh, each of the n
    hops folding a K1 result with global rows. The lexicographic fold
    keeps the lowest-row tie-break whatever the hop order. Same contract
    as `sharded_l1_argmin`, including the streamed route past the device
    budget."""
    n = mesh.size
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    home = _home(mesh)
    if lib.numel() // n > dd.DEVICE_LIB_BYTES_MAX and l > dd._TL_SEG:
        da, ra = dd.l1_topk_streamed(
            blocks, lib, 1, device=home,
            scorer=_argmin_bank_scorer(sharded_l1_argmin_ring, mesh, n),
        )
        return da[:, 0], ra[:, 0]
    blocks_p = _pad_rows_with_first(blocks, n)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, l, blocks.shape[1], n)
    else:
        lib_p = _pad_rows_with_first(lib, n)
    bs, ls = blocks_p.shape[0] // n, lib_p.shape[0] // n
    own = mesh.local_positions()
    xs, ts = _Slices(blocks_p, bs), _Slices(lib_p, ls)
    x = {p: xs(p, mesh.device(p)) for p in own}
    slabs = {p: ts(p, mesh.device(p)) for p in own}
    best = {
        p: (torch.full((bs,), I32_MAX, dtype=torch.int32, device=mesh.device(p)),
            torch.zeros((bs,), dtype=torch.int32, device=mesh.device(p)))
        for p in own
    }
    for hop in range(n):
        for p in own:
            dist, row = dd.l1_argmin(x[p], slabs[p])
            grow = row + ((p - hop) % n) * ls  # the slab came from shard p - hop
            bd, br = best[p]
            take = (dist < bd) | ((dist == bd) & (grow < br))
            best[p] = (torch.where(take, dist, bd), torch.where(take, grow, br))
        if hop + 1 < n:
            slabs = _ring_pass(slabs, mesh)
    parts = exchange({p: torch.stack(best[p]) for p in own}, home)
    both = torch.cat([parts[p].to(home) for p in range(n)], dim=1)
    return _host(both[0])[:b], _host(both[1])[:b]


def _local_topk(x, t, k: int, row_offset: int, real_l: int) -> torch.Tensor:
    """Per-shard stripe top-k with GLOBAL rows: x [rows, D] against this
    shard's slice t (global rows row_offset.., padding at real_l and past
    masked to I32_MAX). Returns the k least packed (distance, global row)
    int64 keys per row, ascending (not `torch.topk`'s tie order)."""
    rows, ls = x.shape[0], t.shape[0]
    cols = torch.arange(row_offset, row_offset + ls, device=x.device)
    pad = cols >= real_l
    out = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    bc = dd._stripe_rows(ls, 8)
    for r0 in range(0, rows, bc):
        dist = dd.l1_block(x[r0 : r0 + bc], t).masked_fill_(pad, I32_MAX)
        out[r0 : r0 + bc] = dd._least(dd._keys(dist, cols), k)
        del dist
    return out


def sharded_l1_topk(blocks, lib, k: int, mesh: Mesh, *, prepared=None):
    """Exact k nearest rows per block over a ("data", "model") mesh.

    Blocks split over "data", the library over "model"; each shard's
    stripe top-k (`l1_block`, packed keys) is merged by the same key sort,
    bit-identical to `ops.distance.l1_topk_stripes` including tie order
    and the I32_MAX/row-0 padding when k > L. Returns host numpy
    (dists [B, k] int32, rows [B, k] int32).
    """
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, l = blocks.shape[0], lib.shape[0]
    home = _home(mesh)
    if lib.numel() // n_model > dd.DEVICE_LIB_BYTES_MAX and l > dd._TL_SEG:
        # per-"model" shard past the device budget: stream host banks
        # through this same route (banks are clamped under the budget)
        def bank_scorer(bb, ll, kx, prepared=None):
            return sharded_l1_topk(bb, ll, kx, mesh, prepared=prepared)

        bank_scorer.prepare = _pad_prepare(n_model, home)
        return dd.l1_topk_streamed(blocks, lib, k, scorer=bank_scorer, device=home)
    kk = min(k, l)
    blocks_p = _pad_rows_with_first(blocks, n_data)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, l, blocks.shape[1], n_model)
    else:
        lib_p = _pad_rows_with_first(lib, n_model)
    ls = lib_p.shape[0] // n_model
    # a shard's k is capped by its size; the merged M * k_loc >= kk keys
    # always hold the true top kk (if ls < kk then M * ls >= L >= kk)
    k_loc = min(kk, ls)
    xs, ts = _Slices(blocks_p, blocks_p.shape[0] // n_data), _Slices(lib_p, ls)
    local = {}
    for pos in mesh.local_positions():
        i, m = divmod(pos, n_model)
        dev = mesh.device(pos)
        local[pos] = _local_topk(xs(i, dev), ts(m, dev), k_loc, m * ls, l)
    parts = exchange(local, home)
    keys = torch.cat([
        dd._least(torch.cat([parts[i * n_model + m].to(home) for m in range(n_model)], 1), kk)
        for i in range(n_data)
    ])
    dist, rows = dd._unkey(keys)
    rows = torch.where(dist == I32_MAX, 0, rows)  # l1_topk's padding: row 0
    return dd._pad_topk(_host(dist)[:b], _host(rows)[:b], b, k, kk)


def sharded_l1_topk_adaptive(blocks, lib, k: int, mesh: Mesh, *, prepared=None,
                             stats: dict | None = None):
    """Exact k nearest rows per block via the adaptive certified scorer,
    blocks split over EVERY mesh position, the library replicated (the
    coarse bounds need all of it; on a repeated device it is one tensor).

    Bit-identical to `ops.distance.l1_topk_adaptive`: each shard runs the
    same stages (K9's coarse pass, K3's rescore) on its rows, per-row
    results do not depend on the shard, and uncertified rows take the
    same stripe fallback, then the same audit. Shapes the scorer declines,
    and concentrated data caught by its sample gate on one chunk, go to
    `sharded_l1_topk`. A library past the device budget streams host banks
    through this scorer. `prepared` is an `_ad_prepare` handle for THIS
    lib. `stats`, when given, records the route, the shard count and the
    certified and fallback rows.
    """
    blocks, lib = _as_u8(blocks), _as_u8(lib)
    b, d = blocks.shape
    l = lib.shape[0]
    home = _home(mesh)
    st = stats if stats is not None else {}
    st.update(route="adaptive", blocks=b, shards=mesh.size)
    if lib.numel() > dd.DEVICE_LIB_BYTES_MAX and l > dd._TL_SEG:
        # the library replicates per device: past the budget, each bank is
        # scored by THIS sharded scorer (banks are under the budget)
        def bank_scorer(bb, ll, kx, prepared=None):
            return sharded_l1_topk_adaptive(bb, ll, kx, mesh, prepared=prepared)

        bank_scorer.prepare = lambda ll, d_, b_=None, k_=None: dd._ad_prepare(
            ll, d_, b_, k_, device=home)
        st["route"] = "streamed"
        return dd.l1_topk_streamed(blocks, lib, k, scorer=bank_scorer, device=home)
    eligible, g, chan, kk, lp, nseg, m, cap, _ = dd._ad_plan(b, l, d, k, device=home)
    if not eligible:
        st["route"] = "stripes (ineligible shape)"
        return sharded_l1_topk(blocks, lib, k, mesh)
    base = dd._check_ad_prepared(prepared, l, lp, d) if prepared is not None else None
    pads, coarse = {}, {}
    for pos in mesh.local_positions():
        dev = mesh.device(pos)
        if dev not in pads:
            pads[dev] = base.to(dev) if base is not None else dd._pad_lib(lib, lp, dev)
            coarse[dev] = dd._ad_coarse_lib(pads[dev], d, g, chan, l)
    n_dev = mesh.size
    bc = dd._STRIPE_BC if b >= dd._STRIPE_BC * n_dev else 8
    unit = bc * n_dev  # every slice splits evenly into bc-row chunks
    bp = -(-b // unit) * unit
    blocks_p = torch.cat([blocks, blocks.new_zeros((bp - b, d))]) if bp > b else blocks
    # per-device survivor memory stays that of the single-device scorer
    b_slice = min(bp, dd._ad_b_slice(nseg, cap, bc) * n_dev)

    def stages(x, dev):
        keys, s_min = dd._ad_coarse(x, coarse[dev], d, g, chan, cap)
        return dd._ad_rescore(x, keys, s_min, pads[dev], m=m, k=kk, real_l=l)

    # sample gate on one chunk: concentrated data no lossy projection can
    # prune goes to the stripes before the sharded pass is paid
    _, _, ok_s = stages(blocks_p[:bc].to(home), home)
    if ok_s.float().mean().item() < 0.5:
        st["route"] = "stripes (sample gate)"
        return sharded_l1_topk(blocks, lib, k, mesh)

    def run(sl):
        rs = sl.shape[0] // n_dev
        local = {}
        for pos in mesh.local_positions():
            dev = mesh.device(pos)
            dists, rows, ok = stages(sl[pos * rs : (pos + 1) * rs].to(dev), dev)
            local[(pos, "d")], local[(pos, "r")] = dists, rows
            local[(pos, "ok")] = ok.to(torch.uint8)
        parts = exchange(local, home)
        return tuple(
            torch.cat([parts[(p, name)].to(home) for p in range(n_dev)])
            for name in ("d", "r", "ok")
        )

    out_d, out_r, ok_all = dd._run_block_slices(blocks_p, b_slice, kk, run)
    out_d, out_r = out_d[:b], out_r[:b]
    bad = np.flatnonzero(~ok_all[:b])
    x, lib_dev = blocks.to(home), pads[home][:l]
    out_d, out_r = dd._stripe_fallback(out_d, out_r, bad, x, lib_dev, kk, device=home)
    # the certificate self-audit, as the single-device scorer's; every
    # process holds the same outputs, so every process takes one branch
    out_d, out_r = dd._ad_audit(out_d, out_r, x, lib_dev, l, d, kk,
                                label="sharded_l1_topk_adaptive")
    st.update(certified=int(ok_all[:b].sum()), fallback=int(bad.size))
    return dd._pad_topk(out_d, out_r, b, k, kk)


def sharded_mosaic_step(tiles, source, mesh: Mesh, dim: int, tile_size: int) -> np.ndarray:
    """The whole device pipeline over the mesh: palette analysis of each
    "model" shard's tiles, its flip-augmented library with the single-device
    global row numbering, the match (K1 per shard, folded over "model"),
    then each "data" band's composite (K2 `compose_rows`) from the whole
    tile stack.

    Args:
      tiles: [T, ts, ts, 3] uint8 (T divisible by the "model" size).
      source: [H, W, 3] uint8 (H divisible by dim, its block rows by the
        "data" size).
    Returns the assembled mosaic [H/dim*ts, W/dim*ts, 3] uint8 (host numpy).
    """
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    tiles, source = _as_u8(tiles), _as_u8(source)
    t, ts = tiles.shape[0], tiles.shape[1]
    h, w = source.shape[0], source.shape[1]
    nby, nbx = h // dim, w // dim
    if t % n_model:
        raise ValueError(f"T={t} not divisible by model={n_model}")
    if nby % n_data:
        raise ValueError(f"block rows {nby} not divisible by data={n_data}")
    tsh, bby = t // n_model, nby // n_data
    home = _home(mesh)
    libs, blocks, local = {}, {}, {}
    for pos in mesh.local_positions():
        i, m = divmod(pos, n_model)
        dev = mesh.device(pos)
        if (m, dev) not in libs:
            pal = analyse_batch(tiles[m * tsh : (m + 1) * tsh], dim, device=dev)
            libs[(m, dev)] = dd.build_library(pal)  # [2 Ts, D]: tiles, then flips
        if (i, dev) not in blocks:
            band = source[i * bby * dim : (i + 1) * bby * dim, : nbx * dim]
            blocks[(i, dev)] = source_blocks(band, dim, device=dev)
        dist, lrow = dd.l1_argmin(blocks[(i, dev)], libs[(m, dev)])
        # single-device layout: rows [0, T) unflipped, [T, 2T) flipped;
        # shard m holds [m Ts, (m+1) Ts) of each
        grow = torch.where(lrow < tsh, m * tsh + lrow, t + m * tsh + (lrow - tsh))
        local[pos] = torch.stack([dist, grow])
    _, rows = _fold_argmin(exchange(local, home), n_data, n_model, home)
    items = dd.rows_to_items(rows, t).reshape(nby, nbx)
    # each band composes on its (i, 0) position, from the whole stack
    augs, bands = {}, {}
    for i in range(n_data):
        pos = i * n_model
        if pos in mesh.local_positions():
            dev = mesh.device(pos)
            if dev not in augs:
                augs[dev] = augment_stack2d(tiles, device=dev)[0]
            bands[i] = compose_rows(items[i * bby : (i + 1) * bby].to(dev), augs[dev])
    bands = exchange(bands, home)
    out = torch.cat([bands[i].to(home) for i in range(n_data)])
    return _host(out).reshape(nby * ts, nbx * ts, 3)
