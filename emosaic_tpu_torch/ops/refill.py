"""The no-repeat assignment engine's batched device refill.

Under tail contention the C++ engine's host refill (a masked scan per
exhausted block) dominates assignment. `DeviceRefiller` replaces it with
one device call per refill event, covering every nearly-dry block, from
the first event on: a call of at most `_K12_MAX_M` blocks is one launch of
the hand-written kernel K12 `csrc/masked_refill.cu` (`masked_refill`,
plain version `_masked_refill_ref`), the resident library scored under the
engine's mask and each block's k least (distance, row) pairs selected in
the same call; a larger call scores the library compacted to its unused
rows on K10's stripe (`_refill_topk`), whose ascending index keeps the
(distance, row) order. `refiller_for` is the one rule that decides whether
a render refills on the device at all; the output is bit-identical either
way.

A TPU-only device of the JAX package that this port drops: the fixed
padded shapes of `_refill_topk_jit` (XLA compile caching); torch runs
each event at its own shape.
"""
from __future__ import annotations

import numpy as np
import torch

from emosaic_tpu_torch.monitor import span
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import MASKED_REFILL
from emosaic_tpu_torch.ops.distance import (
    I32_MAX,
    _as_u8,
    _host,
    _l1_block_ref,
    _pad_words,
    _topk_rows,
    l1_block,
)

#: a render refills on the device once L * D makes the C++ engine's
#: per-block host scan expensive (`refiller_for`)
_DEVICE_REFILL_MIN_LD = 10**8
#: K12 (`csrc/masked_refill.cu`): warps a block of its distance pass (a
#: block walks tiles of that many groups of 32 library rows), its blocks an
#: SM at most, and the largest k its selection sorts in shared memory
_K12_WARPS = 8
_K12_BLOCKS_PER_SM = 4
_K12_MAX_K = 2048
#: bins of K12's histogram of a block's distances (their top 11 bits)
_K12_BINS = 2048
#: refill calls of at most this many blocks take K12; larger ones (many
#: blocks whose short candidate lists run dry together, as over a flat
#: region of the photo) gather the unused rows for K10's stripe, whose
#: 128-row query tiles run near the VABSDIFF4 ceiling once they are full.
#: K12 loads each library row once a call but reads its query rows
#: through L1, four blocks a pass, so its time grows with M where the
#: stripe's barely does. A whole call at 65534 x 3072, 37k rows unused,
#: k = 256, K12 against the stripe's route (probes/k12.py, one H100 80GB
#: HBM3 at 700 W): M = 1 0.16 ms against 1.00; 16: 0.26 against 1.28; 32:
#: 0.40 against 1.26; 64: 0.79 against 1.19; 96: 1.05 against 1.36; 128:
#: 1.60 against 1.45; 256: 3.08 against 2.06; 4096: 81.8 against 34.4.
_K12_MAX_M = 96


def refiller_for(blocks, lib) -> DeviceRefiller | None:
    """The refill callback of a no-repeat render's native engine: a
    `DeviceRefiller` on the blocks' device, or None, the engine's exact
    host masked scan, where L * D is under `_DEVICE_REFILL_MIN_LD` or the
    library is past `distance.DEVICE_LIB_BYTES_MAX`. Both are read at call
    time, so tuning or a test's patch applies."""
    ld = lib.shape[0] * lib.shape[1]
    if ld < _DEVICE_REFILL_MIN_LD or ld > distance.DEVICE_LIB_BYTES_MAX:
        return None
    return DeviceRefiller(blocks, lib)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k12_plan(l: int, d: int, sms: int) -> tuple[int, int, int, int]:
    """K12's launch for l library rows of d bytes on a card of `sms` SMs:
    (16-byte vectors a row, padded; the stride of a query's int32
    distances, whole 16-byte vectors; the bits of the largest distance a
    padded row can reach; blocks of the distance pass, one a tile of
    `_K12_WARPS` groups of 32 rows, at most `_K12_BLOCKS_PER_SM` an SM).
    The selection takes one block a query."""
    nv = -(-d // 16)
    ld = -(-l // 4) * 4
    bits = (255 * 16 * nv).bit_length()
    groups = -(-l // 32)
    return nv, ld, bits, min(-(-groups // _K12_WARPS), sms * _K12_BLOCKS_PER_SM)


def masked_refill(blocks: torch.Tensor, ids: torch.Tensor, lib: torch.Tensor,
                  used: torch.Tensor, k: int) -> torch.Tensor:
    """The k least (distance, row) pairs of each block `blocks[ids]` over
    the rows of `lib` with `used[row] == 0`, ascending, the lowest row
    first among equal distances, padded with (I32_MAX, 0) past the unused
    rows: int32 [2, M, k], dists then rows, on the blocks' device.

    blocks [B, D] and lib [L, D] u8, ids [M] int64, used [L] u8 (nonzero:
    excluded), all on one device. On the card it launches the hand-written
    kernel K12 `csrc/masked_refill.cu` (the resident rows are read in
    place: no gather, no copy where D is a multiple of 16); on a CPU
    tensor it runs `_masked_refill_ref`, its plain torch version."""
    if blocks.device.type == "cpu":
        return _masked_refill_ref(blocks, ids, lib, used, k)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    m, l = ids.numel(), lib.shape[0]
    if not all(x.device == blocks.device for x in (ids, lib, used)):
        raise ValueError("blocks, ids, lib and used must share one device")
    if blocks.dtype != torch.uint8 or lib.dtype != torch.uint8 or used.dtype != torch.uint8:
        raise ValueError("blocks, lib and used must be uint8")
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be contiguous int64 [M]")
    if used.shape != (l,) or not used.is_contiguous() or blocks.shape[1] != lib.shape[1]:
        raise ValueError(f"shapes {tuple(blocks.shape)} / {tuple(lib.shape)} / {tuple(used.shape)}")
    if not 1 <= k <= _K12_MAX_K:
        raise ValueError(f"K12 takes 1 <= k <= {_K12_MAX_K}, got {k}")
    if m == 0 or l == 0:
        out = torch.empty((2, m, k), dtype=torch.int32, device=blocks.device)
        out[0].fill_(I32_MAX)
        out[1].zero_()
        return out
    plan = _k12_plan(l, blocks.shape[1], _sm_count(blocks.device))
    w = 16 * plan[0]
    x, t = _pad_words(blocks, w, 16), _pad_words(lib, w, 16)
    work = torch.empty(_k12_work(m, plan[1], k), dtype=torch.int32, device=blocks.device)
    return _k12_launch(x, t, ids.data_ptr(), used.data_ptr(), work, m, k, plan)


def _k12_work(m: int, ld: int, k: int) -> int:
    """int32 words of K12's scratch and output for m blocks: the
    histograms [m, `_K12_BINS`], the distances [m, ld], then [2, m, k]."""
    return m * (_K12_BINS + ld + 2 * k)


def _k12_launch(x, t, ids: int, used: int, work: torch.Tensor, m: int, k: int, plan,
                up=(None, None, 0), down=None):
    """Launch K12 on rows x [B, 16 nv] and t [L, 16 nv] (padded, aligned)
    with m int64 block ids and the [L] u8 mask at the device addresses
    `ids` and `used`, into `work` (`_k12_work` int32 words, 16-byte
    aligned); returns the output, int32 [2, m, k], a view of `work`. `up`
    (host source, device destination, bytes) is copied first and the
    output to the host address `down` last, in the same call (page-locked
    buffers: the copies are asynchronous)."""
    nv, ld, bits, grid = plan
    base = work.data_ptr()
    o = m * (_K12_BINS + ld)
    MASKED_REFILL.launch(
        x.device.index, x.data_ptr(), t.data_ptr(), ids, used, base,
        base + 4 * m * _K12_BINS, base + 4 * o, m, t.shape[0], ld, nv, k, bits, grid,
        *up, down, torch.cuda.current_stream(x.device).cuda_stream,
    )
    return work[o : o + 2 * m * k].view(2, m, k)


def _masked_refill_ref(blocks, ids, lib, used, k: int) -> torch.Tensor:
    """Plain torch version of K12 (`masked_refill`), on any device: the
    int32 distances of the queried blocks to every row, I32_MAX on used
    rows, then the packed-key selection."""
    m, l = ids.numel(), lib.shape[0]
    out = torch.empty((2, m, k), dtype=torch.int32, device=blocks.device)
    out[0].fill_(I32_MAX)
    out[1].zero_()
    kk = min(k, l)
    if m == 0 or kk == 0:
        return out
    dist = _l1_block_ref(blocks.index_select(0, ids), lib)
    dist[:, used != 0] = I32_MAX
    dd, rr = _topk_rows(dist, kk)
    out[0, :, :kk] = dd
    out[1, :, :kk] = torch.where(dd == I32_MAX, 0, rr)
    return out


def _refill_topk(blocks_dev, ids_dev, sub, unused_dev, kk: int):
    """Exact ascending (distance, row) top-kk of each queried block over
    the compacted unused rows `sub` (library rows `unused_dev`, ascending).
    Returns host int32 (dists [M, kk], rows [M, kk])."""
    dist = l1_block(blocks_dev.index_select(0, ids_dev), sub)
    dd, pos = _topk_rows(dist, kk)
    return _host(dd), _host(unused_dev[pos.to(torch.int64)].to(torch.int32))


class DeviceRefiller:
    """Batched masked top-k refill engine (native.greedy_global callback).

    Callable as (block_ids [M] int, used uint8/bool [L]) ->
    (dists [M, k] int32, rows [M, k] int32), ascending (distance, row)
    over the rows with used[r] == 0, I32_MAX-padded: the exact contract of
    the C++ engine's host masked scan (and of rendering.rs:383-385's live
    kd-tree re-fetch, whose mutating tree this mask replaces).

    Blocks and library stay on the blocks' device (the render's own
    tensors: nothing is copied), and every event is a device call from the
    first one. A call of at most `_K12_MAX_M` blocks is one K12 launch
    (`masked_refill`) on the resident library: the mask and the block ids
    go up in one copy from a reused page-locked buffer, and dists and rows
    come back in one. A larger call gathers the unused rows and scores
    them on K10's stripe (`_refill_topk`). A library past
    `distance.DEVICE_LIB_BYTES_MAX` is refused; `refiller_for` leaves such
    a render on the engine's host scan.
    """

    def __init__(self, blocks, lib, *, k: int = 256):
        if not 1 <= k <= _K12_MAX_K:
            raise ValueError(f"k must be in 1..{_K12_MAX_K}, got {k}")
        lib = _as_u8(lib)
        if lib.numel() > distance.DEVICE_LIB_BYTES_MAX:
            raise ValueError(f"a library of {lib.numel()} bytes is past the device budget "
                             f"({distance.DEVICE_LIB_BYTES_MAX})")
        self._blocks = _as_u8(blocks)
        self.device = self._blocks.device
        self.b, self.d = self._blocks.shape
        self.l = lib.shape[0]
        self.k = k
        #: public: the query-batch capacity per device call; callers cap
        #: their refill batches to it (render/norepeat.py)
        self.max_batch = 1 << (min(self.b, 4096) - 1).bit_length()
        self._lib = lib.to(self.device)
        if self.device.type == "cuda":
            # K12's plan, and its whole 16-byte vectors: padded once here
            # (no copy at D a multiple of 16)
            self._plan = _k12_plan(self.l, self.d, _sm_count(self.device))
            w = 16 * self._plan[0]
            self._blocks, self._lib = _pad_words(self._blocks, w, 16), _pad_words(self._lib, w, 16)
        #: device calls, the blocks they covered, the unused rows they
        #: scored, and the calls K12 served
        self.n_calls = 0
        self.n_blocks = 0
        self.n_rows = 0
        self.n_fused = 0
        self._cap = 0  # K12's staged blocks a call (`_stage`, at the first call)

    def _stage(self, m: int) -> None:
        """The reused buffers of K12 calls of up to `self._cap` >= m
        blocks: on the host, page-locked, the mask then the block ids
        (int64, 16-byte aligned), and the dists and rows that come back; on
        the card, the mask's and ids' copy, and K12's scratch and output."""
        self._cap = max(m, min(self.max_batch, _K12_MAX_M))
        self._off = -(-self.l // 16) * 16
        self._up_h = torch.empty(self._off + 8 * self._cap, dtype=torch.uint8, pin_memory=True)
        self._up_d = torch.empty_like(self._up_h, device=self.device)
        self._work = torch.empty(_k12_work(self._cap, self._plan[1], self.k), dtype=torch.int32,
                                 device=self.device)
        self._down_h = torch.empty(2 * self._cap * self.k, dtype=torch.int32, pin_memory=True)
        up = self._up_h.numpy()
        self._used_h, self._ids_h = up[: self.l], up[self._off :].view(np.int64)

    def _fused(self, ids: np.ndarray, used: np.ndarray):
        m = len(ids)
        if self.device.type != "cuda":  # the plain version
            out = masked_refill(self._blocks, torch.from_numpy(np.asarray(ids, np.int64)),
                                self._lib, torch.from_numpy(used.astype(np.uint8)), self.k)
            out = out.numpy()
        else:
            if m > self._cap:
                self._stage(m)
            np.copyto(self._used_h, used, casting="unsafe")
            self._ids_h[:m] = ids
            # one call: the mask and ids up, K12, dists and rows down
            up = self._up_d.data_ptr()
            n = self._off + 8 * m
            _k12_launch(self._blocks, self._lib, up + self._off, up, self._work, m, self.k,
                        self._plan, up=(self._up_h.data_ptr(), up, n),
                        down=self._down_h.data_ptr())
            torch.cuda.current_stream(self.device).synchronize()
            out = self._down_h[: 2 * m * self.k].numpy()
        out = out.reshape(2, m, self.k)
        return out[0].copy(), out[1].copy()

    def __call__(self, ids: np.ndarray, used: np.ndarray):
        used = np.asarray(used)
        with span("norepeat.refill"):
            m = len(ids)
            n_unused = self.l - int(np.count_nonzero(used))
            if n_unused == 0:
                return np.full((m, self.k), I32_MAX, np.int32), np.zeros((m, self.k), np.int32)
            if m <= _K12_MAX_M:
                self.n_calls += 1
                self.n_fused += 1
                self.n_blocks += m
                self.n_rows += n_unused
                return self._fused(ids, used)
            out_d = np.full((m, self.k), I32_MAX, np.int32)
            out_r = np.zeros((m, self.k), np.int32)
            unused = np.flatnonzero(used == 0)
            kk = min(self.k, unused.size)
            unused_dev = torch.from_numpy(unused).to(self.device)
            sub = self._lib.index_select(0, unused_dev)
            ids = torch.from_numpy(np.asarray(ids, dtype=np.int64))
            for lo in range(0, m, self.max_batch):  # normally a single chunk
                chunk = ids[lo : lo + self.max_batch].to(self.device)
                dd, rr = _refill_topk(self._blocks, chunk, sub, unused_dev, kk)
                self.n_calls += 1
                self.n_blocks += len(chunk)
                self.n_rows += unused.size
                out_d[lo : lo + self.max_batch, :kk] = dd
                out_r[lo : lo + self.max_batch, :kk] = rr
        return out_d, out_r
