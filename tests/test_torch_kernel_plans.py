"""The launch plans of K1 and K3 (`ops/distance.py` `_k1_plan`,
`_k3_plan`): the Python side of the kernels, checked on the CPU.

K1 takes the register path for rows of at most 16 words (D <= 64) and the
staged path, on rows padded to 16-byte vectors, above; its library splits
cover every tile once. K3's grouped path takes rows of 512 bytes and more
and a power-of-two group of query rows that fits the shared memory beside
its sort; narrower rows, and rows too wide for one beside the sort, take
the per-query path.
"""

import numpy as np
import pytest

from emosaic_tpu_torch.ops import distance as P


@pytest.mark.parametrize(
    "d,dw", [(3, 1), (12, 3), (27, 7), (48, 12), (61, 16), (64, 16), (65, 20), (68, 20),
             (75, 20), (192, 48), (3072, 768), (65800, 16452)]
)
def test_k1_row_width_and_path(d, dw):
    assert P._k1_plan(100, 1000, d, 132)[0] == dw
    assert (dw <= P._K1_REG_WORDS) == (d <= 64)
    if dw > P._K1_REG_WORDS:
        assert dw % 4 == 0  # whole 16-byte vectors for the staged path


@pytest.mark.parametrize(
    "b,l,d,sms",
    [(262144, 200000, 48, 132), (4096, 200000, 48, 132), (4096, 200000, 3072, 132),
     (1, 3, 3, 132), (7, 100000, 48, 132), (3, 20000, 300, 132), (1000, 257, 12, 132),
     (5, 300, 65800, 132), (1, 2**31 - 1, 3, 132), (2**20, 10**6, 48, 1)],
)
def test_k1_splits_cover_the_library(b, l, d, sms):
    dw, qtiles, nsplit, per = P._k1_plan(b, l, d, sms)
    tq, tl = P._K1_REG_TILE if dw <= P._K1_REG_WORDS else P._K1_STAGED_TILE
    ntiles = -(-l // tl)
    assert qtiles == -(-b // tq)
    assert 1 <= nsplit <= 65535 and per >= 1
    assert nsplit * per >= ntiles > (nsplit - 1) * per  # every split non-empty
    if qtiles < sms * P._BLOCKS_PER_SM and ntiles >= sms * P._BLOCKS_PER_SM:
        assert qtiles * nsplit >= sms * P._BLOCKS_PER_SM  # the grid fills the card


def test_k1_main_path_plans():
    # the mode-4 repeat path: 1024 query tiles, the library split in two
    assert P._k1_plan(262144, 200000, 48, 132) == (12, 1024, 2, 391)
    # few queries: 16 query tiles x 66 splits = 8 blocks per SM
    assert P._k1_plan(4096, 200000, 48, 132) == (12, 16, 66, 12)


@pytest.mark.parametrize("d", [3, 12, 48, 192, 496])
def test_k3_narrow_rows_take_the_per_query_path(d):
    assert P._k3_plan(1024, -(-d // 16)) == (0, 0)


@pytest.mark.parametrize(
    "m,d,want",
    [(1024, 3072, (16, 10)),     # the flagship rescore: 16 queries, one pass
     (1024, 49152, (2, 10)),     # two 48 KB rows beside the sort
     (1024, 768, (16, 10)),
     (1, 768, (64, 0)),          # the largest group
     (8192, 3072, (2, 13)),      # the flat-library probe's lists
     (20000, 3072, (1, 14)),     # longer than one pass: two passes
     (300, 512, (32, 9))],
)
def test_k3_group_and_pass(m, d, want):
    assert P._k3_plan(m, d // 16) == want


@pytest.mark.parametrize("m", [1, 7, 64, 1000, 1024, 1025, 5000, 16384, 40000])
@pytest.mark.parametrize("d", [512, 768, 3072, 12288, 49152, 131072])
def test_k3_plan_fits_the_kernel(m, d):
    nvec = d // 16
    group, mc_log2 = P._k3_plan(m, nvec)
    assert group >= 1 and group & (group - 1) == 0 and group <= P._K3_GROUP_MAX
    assert group << mc_log2 <= P._K3_ENTRIES  # one pass fits the sort
    assert P._K3_SORT_BYTES + group * nvec * 16 <= P._K3_SMEM_BYTES
    mc = 1 << mc_log2
    assert mc >= min(m, P._K3_ENTRIES // group)  # no pass is needlessly short
    assert mc < 2 * m or mc == 1  # nor needlessly long


def test_k3_rows_too_wide_for_a_group_take_the_per_query_path():
    nvec = (P._K3_SMEM_BYTES - P._K3_SORT_BYTES) // 16 + 1
    assert P._k3_plan(64, nvec) == (0, 0)


# K4 and K9 (`csrc/seg_topcap.cu`, `csrc/coarse_topcap.cu`). The C entry
# points refuse a plan that does not match their own constants.

#: the shared memory one block may use on an H100, and one SM's (with 1 KB
#: reserved a block)
_SMEM_BLOCK_MAX = 227 * 1024
_SM_SMEM = 228 * 1024


@pytest.mark.parametrize("rows,nseg", [(1, 1), (3, 7), (96, 512), (16384, 512), (16400, 512),
                                       (1341, 1563), (2, 15625), (127, 1)])
def test_k4_blocks_cover_every_chunk_once(rows, nseg):
    blocks, smem = P._k4_plan(rows, nseg)
    chunks = rows * nseg
    # block i stages chunks 128i .. 128i + 127; only the last one is ragged
    assert blocks * P._K4_CHUNKS >= chunks > (blocks - 1) * P._K4_CHUNKS
    assert blocks <= 2**31 - 1
    assert smem == P._K4_CHUNKS * P._SEG_ROW_WORDS * 4 <= _SMEM_BLOCK_MAX
    assert 3 * (smem + 1024) <= _SM_SMEM  # three blocks share an SM
    # a chunk's 16-byte reads: 33 units apart, distinct banks in a phase of 8
    assert P._SEG_ROW_WORDS >= P._TL_SEG and P._SEG_ROW_WORDS % 4 == 0
    assert len({(t * P._SEG_ROW_WORDS // 4) % 8 for t in range(8)}) == 8


def test_k4_flagship_stripe_passes_4_gib_in_one_plan():
    rows, nseg = 16400, 512
    blocks, _ = P._k4_plan(rows, nseg)
    assert rows * nseg * 128 * 4 > 2**32 and blocks == 65600


@pytest.mark.parametrize("rows,nseg", [(1, 1), (37, 7), (300, 512), (129, 1563), (200, 977)])
def test_k9_tiles_cover_every_row_segment_pair_once(rows, nseg):
    rpad, blocks, _, _ = P._k9_plan(rows, nseg, 96)
    assert rpad % P._K9_TQ == 0 and rows <= rpad < rows + P._K9_TQ
    count = np.zeros((rows, nseg), np.int64)
    for bid in range(blocks):  # block qt * nseg + s: query tile qt, segment s
        qt, s = divmod(bid, nseg)
        count[qt * P._K9_TQ : (qt + 1) * P._K9_TQ, s] += 1
    assert (count == 1).all()


def test_k9_flagship_plan():
    # 4096-row chunks of the flagship's 16384 blocks against 512 segments
    assert P._k9_plan(4096, 512, 96) == (4096, 32 * 512, 3, 67584)


@pytest.mark.parametrize("dout", [1, 5, 6, 9, 24, 27, 31, 32, 33, 96, 384, 1536])
def test_k9_k_loop_covers_every_coordinate(dout):
    _, _, steps, _ = P._k9_plan(100, 3, dout)
    seen = [c for k in range(steps) for c in range(k * P._K9_KT, min(dout, (k + 1) * P._K9_KT))]
    assert seen == list(range(dout))
    assert all(min(P._K9_KT, dout - k * P._K9_KT) > 0 for k in range(steps))


@pytest.mark.parametrize(
    "mode,dout", [(4, 6), (8, 6), (16, 24), (6, 27), (32, 96), (64, 384), (128, 1536)]
)
def test_k9_shared_memory_fits_every_planned_dout(mode, dout):
    d = 3 * mode * mode
    _, g, chan, *_ = P._ad_plan(16384, 65534, d, 512)
    assert chan and (d // 3 // g) * 3 == dout
    _, _, _, smem = P._k9_plan(16384, 512, dout)
    ring = 4 * 2 * P._K9_KT * (P._K9_TQ + P._TL_SEG)
    assert ring <= smem and 4 * P._K9_TQ * P._SEG_ROW_WORDS <= smem
    assert smem <= _SMEM_BLOCK_MAX
    assert 2 * (smem + 1024) <= _SM_SMEM  # two blocks share an SM


# K10 (`csrc/l1_topcap.cu`): one block per (query tile, library tile);
# the C entry points refuse a plan that does not match their tiles.


def _k10_tile(bid, ntq, ntl, qg=8):
    """The kernel's block order (`tile_of`): groups of qg query tiles,
    library tile by library tile inside a group."""
    per_group = qg * ntl
    g, r = divmod(bid, per_group)
    gq = min(qg, ntq - g * qg)
    return g * qg + r % gq, r // gq


@pytest.mark.parametrize(
    "d,dw", [(3, 4), (12, 4), (16, 4), (17, 8), (48, 12), (50, 16), (768, 192),
             (3072, 768), (49152, 12288)]
)
def test_k10_row_width_is_whole_vectors(d, dw):
    assert P._k10_plan(5, 300, d)[0] == dw
    assert dw % 4 == 0 and 4 * dw >= d > 4 * dw - 16


@pytest.mark.parametrize("rows,l", [(1, 1), (127, 129), (300, 700), (1000, 128), (4096, 1000),
                                    (1025, 3000), (129, 130 * 128)])
def test_k10_blocks_cover_every_tile_pair_once(rows, l):
    _, ntq, blocks, _ = P._k10_plan(rows, l, 48)
    ntl = -(-l // P._K10_T)
    assert ntq == -(-rows // P._K10_T) and blocks == ntq * ntl
    seen = np.zeros((ntq, ntl), np.int64)
    for bid in range(blocks):
        qt, lt = _k10_tile(bid, ntq, ntl)
        seen[qt, lt] += 1
    assert (seen == 1).all()


def test_k10_flagship_plans_and_shared_memory():
    # the worst case's 16384 blocks against 65534 rows of 3072 bytes
    dw, ntq, blocks, smem = P._k10_plan(16384, 65534, 3072)
    assert (dw, ntq, blocks) == (768, 128, 128 * 512)
    # the ring of two 16-word stages, then over it the int32 sums at the
    # selection's stride: one block of 256 threads fits
    assert smem == 4 * max(P._K10_RING_WORDS, 128 * P._SEG_ROW_WORDS) == 67584
    assert P._K10_RING_WORDS * 4 <= 48 * 1024  # the stripe entry's static ring
    assert 3 * (smem + 1024) <= _SM_SMEM


@pytest.mark.parametrize("l", [1, 127, 65534, 2**24, 2**31 - 1])
def test_k10_rows_per_launch_keep_the_grid_in_int32(l):
    rows = P._k10_rows(l)
    assert rows % P._K10_T == 0 and rows >= P._K10_T
    assert P._k10_plan(rows, l, 12)[2] <= 2**31 - 1


def test_k10_entries_share_one_source_and_count_apart():
    from emosaic_tpu_torch.ops._kernels import L1_STRIPE, L1_TOPCAP

    assert L1_STRIPE.source == L1_TOPCAP.source and L1_STRIPE.source.name == "l1_topcap.cu"
    assert L1_STRIPE.library == L1_TOPCAP.library
    assert (L1_STRIPE.name, L1_TOPCAP.name) == ("l1_stripe", "l1_topcap")
