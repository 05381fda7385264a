"""The launch plans of K1, K3, K4, K9 and K10 (`ops/distance.py` `_k1_plan`,
`_k3_plan`, `_k4_plan`, `_k9_plan`, `_k10_plan`): the Python side of the
kernels, checked on the CPU.

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


# K9 (`csrc/coarse_topcap.cu`): a persistent grid, one block an SM (or one
# an item, whichever is fewer), each walking the (query tile, segment)
# items by a static stride, its two teams taking them in turn; each team's
# first thread feeds the team's ring of 16-coordinate stages by TMA boxes.


def _k9_item(w, ntq, nseg, qg=8):
    """The kernel's item order (`item_of`): groups of qg query tiles,
    segment by segment inside a group, the last group possibly narrower."""
    g, r = divmod(w, qg * nseg)
    gq = min(qg, ntq - g * qg)
    return g * qg + r % gq, r // gq


@pytest.mark.parametrize(
    "rows,nseg,sms",
    [(1, 1, 132), (5, 3, 132), (37, 7, 132), (300, 51, 132), (300, 512, 132), (129, 1563, 132),
     (200, 977, 132), (1341, 1563, 132), (4096, 512, 132), (1000, 10, 7)],
)
def test_k9_items_cover_every_row_segment_pair_once(rows, nseg, sms):
    rpad, items, grid, _ = P._k9_plan(rows, nseg, 96, sms)
    assert rpad % P._K9_TQ == 0 and rows <= rpad < rows + P._K9_TQ
    ntq = rpad // P._K9_TQ
    assert items == ntq * nseg and grid == min(sms, items)
    count = np.zeros((ntq, nseg), np.int64)
    teams = np.full((ntq, nseg), -1, np.int64)
    walks = []
    for b in range(grid):  # block b takes items b, b + grid, ...; team j % 2 the j-th
        walk = list(range(b, items, grid))
        walks.append(len(walk))
        for j, w in enumerate(walk):
            qt, s = _k9_item(w, ntq, nseg)
            count[qt, s] += 1
            teams[qt, s] = j % 2
    assert (count == 1).all()
    # every block has an item, and the blocks' loads are at most one apart
    assert min(walks) >= 1 and max(walks) - min(walks) <= 1
    if items <= sms:
        assert walks == [1] * items
    assert (teams >= 0).all() and (teams == 1).any() == (max(walks) > 1)


@pytest.mark.parametrize("dout", [1, 5, 6, 9, 24, 27, 31, 32, 33, 96, 384, 1536])
def test_k9_stages_cover_every_coordinate_once(dout):
    _, _, _, steps = P._k9_plan(100, 3, dout, 132)
    kt = P._K9_KT
    assert steps == -(-dout // kt)
    stages = [list(range(k * kt, min(dout, (k + 1) * kt))) for k in range(steps)]
    assert [c for st in stages for c in st] == list(range(dout))
    assert all(stages)
    # the consumers sum whole pairs of coordinates: a short last stage's
    # extra coordinate is still inside the box, past dout, a TMA zero
    for k, st in enumerate(stages):
        read = range(k * kt, k * kt + 2 * -(-len(st) // 2))
        assert read[-1] < (k + 1) * kt and all(c < dout for c in read if c in st)
        assert all(c >= dout for c in read if c not in st)


@pytest.mark.parametrize(
    "mode,dout", [(4, 6), (8, 6), (16, 24), (6, 27), (32, 96), (64, 384), (128, 1536)]
)
def test_k9_shared_memory_fits_every_planned_dout(mode, dout):
    d = 3 * mode * mode
    _, g, chan, *_ = P._ad_plan(16384, 65534, d, 512)
    assert chan and (d // 3 // g) * 3 == dout
    # the rings stream any dout in stages of 16 coordinates: the shared
    # memory does not grow with it
    _, _, _, steps = P._k9_plan(16384, 512, dout, 132)
    assert steps * P._K9_KT >= dout > (steps - 1) * P._K9_KT
    stage = 2 * P._K9_KT * P._K9_TQ * 4  # a [16, 128] f32 box of each operand
    sums = P._K9_TQ * P._SEG_ROW_WORDS * 4  # a team's int32 sums
    assert P._K9_SMEM == 128 + 2 * (P._K9_STAGES * stage + sums) + 64
    assert P._K9_SMEM <= _SMEM_BLOCK_MAX
    assert P._K9_SMEM + 1024 <= _SM_SMEM  # one block an SM
    assert 2 * (P._K9_SMEM + 1024) > _SM_SMEM  # and no second one


def test_k9_flagship_plan():
    # the coarse pass's 4096-row chunks of the flagship's 16384 blocks
    # against 512 segments: 16384 items over 132 blocks, 6 stages an item
    assert P._k9_plan(4096, 512, 96, 132) == (4096, 32 * 512, 132, 6)
    assert P._k9_plan(16384, 512, 96, 132) == (16384, 128 * 512, 132, 6)
    # the 200k shape's chunk: 11 query tiles x 1563 segments
    assert P._k9_plan(1341, 1563, 96, 132) == (1408, 11 * 1563, 132, 6)
    assert (P._K9_TQ, P._K9_KT, P._K9_STAGES, P._K9_SMEM) == (128, 16, 2, 200896)


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 7])
def test_k9_teams_take_alternate_items_and_their_steps(nb):
    # a block's nb items: team t takes items t, t + 2, ...; its ring runs
    # through the steps of those items in order, as many as the kernel's
    # `steps` = (nb - t + 1) // 2 * nk, and its first thread refills slot
    # g % STAGES with step g + STAGES while one remains
    nk = P._k9_plan(1, 1, 96, 132)[3]
    taken = []
    for team in (0, 1):
        items = list(range(team, nb, 2))
        taken += items
        steps = (nb - team + 1) // 2 * nk
        assert steps == len(items) * nk
        seq = [(i, k) for i in items for k in range(nk)]
        assert len(seq) == steps
        for g in range(steps):  # step g's item and step within it, as `load_step` finds them
            assert seq[g] == (team + 2 * (g // nk), g % nk)
        refills = [g + P._K9_STAGES for g in range(steps) if g + P._K9_STAGES < steps]
        assert sorted(list(range(min(P._K9_STAGES, steps))) + refills) == list(range(steps))
    assert sorted(taken) == list(range(nb))


def _k9_select_half(v, h, nvalid, capl):
    """K9's `select_pair` for one half on 128 values: its keys eight at a
    time, each batch sorted and merged into the sorted list as
    min(l[j], b[capl - 1 - j]) and a bitonic sort."""
    def bitonic(m):
        s = len(m) // 2
        while s:
            for j in range(len(m)):
                if not j & s:
                    m[j], m[j + s] = min(m[j], m[j + s]), max(m[j], m[j + s])
            s //= 2
        return m

    lst = [0xFFFFFFFF] * capl
    for b0 in range(64 * h, 64 * h + 64, 8):
        b = sorted((int(v[p]) << 7 | p) if p < nvalid else (1 << 31 | p) for p in range(b0, b0 + 8))
        lst = bitonic([min(lst[j], b[capl - 1 - j]) if capl - 1 - j < 8 else lst[j]
                       for j in range(capl)])
    return lst


@pytest.mark.parametrize("cap", [1, 2, 5, 8, 16, 31, 32])
def test_k9_batched_selection_keeps_the_least_keys_and_the_cap_th_value(cap):
    # each half's list from batches of eight, then the pair's merge (the
    # same bitonic step over the partner's list); s_min takes the value of
    # the cap-th kept key
    capl = 1 << (cap - 1).bit_length()
    rng = np.random.default_rng(cap)
    for hi, nvalid in [(3, 128), (50, 100), (2**20, 128), (5, 0), (1000, 65), (2, 64)]:
        v = rng.integers(0, hi, 128)
        lo, hi_ = _k9_select_half(v, 0, nvalid, capl), _k9_select_half(v, 1, nvalid, capl)
        m = [min(lo[j], hi_[capl - 1 - j]) for j in range(capl)]
        s = capl // 2
        while s:
            for j in range(capl):
                if not j & s:
                    m[j], m[j + s] = min(m[j], m[j + s]), max(m[j], m[j + s])
            s //= 2
        want = sorted((int(v[p]) << 7 | p) if p < nvalid else (1 << 31 | p) for p in range(128))
        assert m == want[:capl]
        key = m[cap - 1]
        worst = P._TL_BIG if key >> 7 == 1 << 24 else key >> 7
        vals = sorted(int(v[p]) if p < nvalid else P._TL_BIG for p in range(128))
        assert worst == vals[cap - 1]


# K10 (`csrc/l1_topcap.cu`): a persistent grid, one block an SM (or one a
# tile, whichever is fewer), each walking the (query tile, library tile)
# pairs by a static stride; a producer thread feeds a ring of 64-word
# stages by TMA boxes. The C entry points refuse a plan that does not match
# their constants.


def _k10_tile(w, ntq, ntl, qg=8):
    """The kernel's tile order (`tile_of`): groups of qg query tiles,
    library tile by library tile inside a group, the last group possibly
    narrower."""
    g, r = divmod(w, qg * ntl)
    gq = min(qg, ntq - g * qg)
    return g * qg + r % gq, r // gq


def _k10_walk(ntq, ntl, grid):
    """Every block's tiles, in the kernel's order: block b takes tiles b,
    b + grid, ... (the producer and the consumers walk the same list)."""
    tiles = ntq * ntl
    return [[_k10_tile(w, ntq, ntl) for w in range(b, tiles, grid)] for b in range(grid)]


@pytest.mark.parametrize(
    "d,dw", [(3, 4), (12, 4), (16, 4), (17, 8), (48, 12), (50, 16), (768, 192),
             (3072, 768), (49152, 12288)]
)
def test_k10_row_width_is_whole_vectors(d, dw):
    assert P._k10_plan(5, 300, d, 132)[0] == dw
    assert dw % 4 == 0 and 4 * dw >= d > 4 * dw - 16


@pytest.mark.parametrize("sms", [132, 5])
@pytest.mark.parametrize("rows,l", [(1, 1), (127, 129), (300, 700), (1000, 128), (4096, 1000),
                                    (1025, 3000), (129, 130 * 128)])
def test_k10_blocks_cover_every_tile_pair_once(rows, l, sms):
    _, ntq, tiles, grid = P._k10_plan(rows, l, 48, sms)
    ntl = -(-l // P._K10_T)
    assert ntq == -(-rows // P._K10_T) and tiles == ntq * ntl
    assert grid == min(sms, tiles)
    seen = np.zeros((ntq, ntl), np.int64)
    walk = _k10_walk(ntq, ntl, grid)
    for block in walk:
        for qt, lt in block:
            seen[qt, lt] += 1
    assert (seen == 1).all()
    # the blocks' loads stay balanced: at most one tile apart
    sizes = [len(b) for b in walk]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("rows,l,sms", [(1, 1, 132), (130, 1000, 132), (1000, 4000, 132),
                                        (4096, 32767, 132), (300, 700, 1000)])
def test_k10_grid_smaller_than_the_sm_count(rows, l, sms):
    # fewer tiles than SMs: one block a tile, each walks one tile
    _, ntq, tiles, grid = P._k10_plan(rows, l, 48, sms)
    assert grid == min(sms, tiles) <= sms
    walk = _k10_walk(ntq, -(-l // P._K10_T), grid)
    assert sorted(w for b in walk for w in b) == sorted(
        (qt, lt) for qt in range(ntq) for lt in range(-(-l // P._K10_T)))
    if tiles <= sms:
        assert all(len(b) == 1 for b in walk)
    else:  # a tile count that is not a multiple of the SMs: the first blocks take one more
        assert [len(b) for b in walk] == [-(-(tiles - b) // grid) for b in range(grid)]


@pytest.mark.parametrize("d", [3, 16, 48, 252, 256, 257, 3072, 3088, 65800])
def test_k10_stages_cover_every_word_once(d):
    # the stages of a row: KW words each, the last one short; the consumers
    # sum whole 16-byte vectors, and the producer copies the 32-word boxes
    # that hold words of the row (zeros past its end)
    dw = P._k10_plan(1, 1, d, 132)[0]
    chunks = [(d0, min(P._K10_KW, dw - d0)) for d0 in range(0, dw, P._K10_KW)]
    assert [w for d0, n in chunks for w in range(d0, d0 + n)] == list(range(dw))
    assert all(n > 0 and n % 4 == 0 for _, n in chunks)
    assert len(chunks) == -(-dw // P._K10_KW)
    boxes = [d0 + 32 * b for d0, n in chunks for b in range(-(-n // 32))]
    assert boxes == list(range(0, dw, 32))


def test_k10_flagship_plans_and_shared_memory():
    # the worst case's 16384 rows against 65534 rows of 3072 bytes: 65536
    # tiles over 132 blocks, 12 stages a tile
    dw, ntq, tiles, grid = P._k10_plan(16384, 65534, 3072, 132)
    assert (dw, ntq, tiles, grid) == (768, 128, 128 * 512, 132)
    # a stage is two TMA boxes (128 rows x 128 bytes) of each operand; the
    # stripe's ring has three, the top-cap's two and its sums, each after
    # up to 1024 bytes that align the ring, and 128 bytes of barriers
    assert P._K10_STAGE_BYTES == 2 * 2 * 128 * 128 == 65536
    assert P._K10_STRIPE_SMEM == 1024 + 3 * 65536 + 128 == 197760
    assert P._K10_TOPCAP_SMEM == 1024 + 2 * 65536 + 128 * P._SEG_ROW_WORDS * 4 + 128 == 199808
    for smem in (P._K10_STRIPE_SMEM, P._K10_TOPCAP_SMEM):
        assert smem <= _SMEM_BLOCK_MAX
        assert smem + 1024 <= _SM_SMEM  # one block an SM
    # the 128-byte swizzle puts 16-byte unit c of row r at unit c ^ (r & 7):
    # the 8 rows a quarter-warp reads (rows tx, tx + 1, ... at one unit)
    # sit in distinct 4-bank groups, and so do the two rows of the query
    # operand a warp reads
    for c in range(8):
        assert len({(r * 128 + 16 * (c ^ (r & 7))) % 128 // 16 for r in range(8)}) == 8


@pytest.mark.parametrize("l", [1, 127, 65534, 2**24, 2**31 - 1])
def test_k10_rows_per_launch_keep_the_grid_in_int32(l):
    rows = P._k10_rows(l)
    assert rows % P._K10_T == 0 and rows >= P._K10_T
    _, ntq, tiles, grid = P._k10_plan(rows, l, 12, 132)
    # int tile indices in the kernel: every tile index plus the stride fits;
    # int TMA row coordinates
    assert tiles <= P._K10_MAX_TILES and tiles + grid <= 2**31 - 1
    assert rows <= 2**31 - 1
    # the last row's offsets into the stripe and the keys fit an int64
    nseg = -(-l // P._K10_T)
    assert rows * l < 2**63 and rows * nseg * 128 < 2**63


def _merge_pair(v, nvalid, capl):
    """`select_segment_pair`'s list path on 128 values: each half's sorted
    list of u32 keys (value << 7) | position (padding (2^24 << 7) |
    position), then min(l[j], partner[capl - 1 - j]) and a bitonic merge."""
    def half(h):
        keys = sorted((int(v[p]) << 7 | p) if p < nvalid else (1 << 31 | p)
                      for p in range(64 * h, 64 * h + 64))
        return keys[:capl]

    lists = [half(0), half(1)]
    m = [min(lists[0][j], lists[1][capl - 1 - j]) for j in range(capl)]
    s = capl // 2
    while s:
        for j in range(capl):
            if not j & s:
                m[j], m[j + s] = min(m[j], m[j + s]), max(m[j], m[j + s])
        s //= 2
    return m


@pytest.mark.parametrize("capl", [1, 2, 4, 8, 16, 32])
def test_k10_pair_merge_keeps_the_least_keys_in_order(capl):
    rng = np.random.default_rng(capl)
    for hi, nvalid in [(3, 128), (50, 100), (2**20, 128), (5, 0), (1000, 65), (2, 64)]:
        v = rng.integers(0, hi, 128)
        want = sorted((int(v[p]) << 7 | p) if p < nvalid else (1 << 31 | p) for p in range(128))
        assert _merge_pair(v, nvalid, capl) == want[:capl]


def test_k10_entries_share_one_source_and_count_apart():
    from emosaic_tpu_torch.ops._kernels import L1_STRIPE, L1_TOPCAP

    assert L1_STRIPE.source == L1_TOPCAP.source and L1_STRIPE.source.name == "l1_topcap.cu"
    assert L1_STRIPE.library == L1_TOPCAP.library
    assert (L1_STRIPE.name, L1_TOPCAP.name) == ("l1_stripe", "l1_topcap")
