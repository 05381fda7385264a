"""K1 to K13 against their plain torch versions on an NVIDIA GPU, and the
sharded routes of `parallel/` on a virtual mesh of the one card.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip
on a host without a GPU. This file imports neither jax nor the JAX
package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops import composite, composite_lab, distance, refill
from emosaic_tpu_torch.ops._kernels import (
    BAND_TRANSPOSE,
    COARSE_TOPCAP,
    COMPOSE,
    COMPOSE_BULK,
    COMPOSE_BULK2,
    FLOOR_WRITE,
    L1_ARGMIN,
    L1_ROWS,
    L1_STRIPE,
    L1_TOPCAP,
    L2_ARGMIN,
    L2_TOPCAP,
    MASKED_REFILL,
    ROW_SORT,
    SEG_TOPCAP,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel under test is CUDA")
    return torch.device("cuda", 0)


def _u8(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize(
    "b,l,d", [(1, 3, 3), (300, 513, 12), (70, 100, 200), (17, 5000, 48), (100, 600, 3072)]
)
def test_k1_matches_plain(cuda, b, l, d):
    rng = np.random.default_rng(b * 7 + d)
    blocks, lib = _u8(rng, (b, d), cuda), _u8(rng, (l, d), cuda)
    before = L1_ARGMIN.launches
    got = distance.l1_argmin(blocks, lib)
    want = distance.l1_argmin_ref(blocks, lib)
    torch.cuda.synchronize()
    assert L1_ARGMIN.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k1_tie_storm_lowest_row(cuda):
    rng = np.random.default_rng(5)
    base = _u8(rng, (700, 12), cuda)
    lib = base.repeat(4, 1)  # 2800 rows, each colour 4 times
    pick = torch.from_numpy(rng.integers(0, 700, size=33)).to(cuda)
    dist, row = distance.l1_argmin(base[pick], lib)
    torch.cuda.synchronize()
    assert bool((dist == 0).all()) and torch.equal(row, pick.to(torch.int32))


@pytest.mark.parametrize("d", [12, 48, 200])
def test_k1_ties_across_lanes_warps_and_splits(cuda, d):
    """Equal rows in one tile (two warps), in other tiles and in other
    library splits, listed out of order: the lowest of them wins, for exact
    copies and for noisy queries near them."""
    rng = np.random.default_rng(d)
    lib = rng.integers(0, 256, size=(9000, d), dtype=np.uint8)
    target = rng.integers(0, 256, size=d, dtype=np.uint8)
    lib[[5000, 41, 8999, 257, 40, 3000]] = target
    near = np.clip(target.astype(int) + rng.integers(-2, 3, size=(6, d)), 0, 255)
    blocks = np.concatenate([np.repeat(target[None], 5, 0), near.astype(np.uint8)])
    x, t = torch.from_numpy(blocks).to(cuda), torch.from_numpy(lib).to(cuda)
    dist, row = distance.l1_argmin(x, t)
    want = distance.l1_argmin_ref(x, t)
    torch.cuda.synchronize()
    assert bool((dist[:5] == 0).all()) and bool((row[:5] == 40).all())
    assert torch.equal(dist, want[0]) and torch.equal(row, want[1])


@pytest.mark.parametrize("d", [60, 64, 65, 68, 75])
def test_k1_register_path_boundary(cuda, d):
    """D = 64 is the register path's widest row (16 words); 65 and up take
    the staged path, padded to 16-byte vectors."""
    rng = np.random.default_rng(d)
    blocks, lib = _u8(rng, (300, d), cuda), _u8(rng, (3000, d), cuda)
    got = distance.l1_argmin(blocks, lib)
    want = distance.l1_argmin_ref(blocks, lib)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,l,d", [(7, 100000, 48), (3, 20000, 300), (1000, 257, 12)])
def test_k1_library_splits(cuda, b, l, d):
    """Few queries against many rows split the library across blocks."""
    rng = np.random.default_rng(b + l)
    blocks, lib = _u8(rng, (b, d), cuda), _u8(rng, (l, d), cuda)
    got = distance.l1_argmin(blocks, lib)
    want = distance.l1_argmin_ref(blocks, lib)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k1_widest_rows(cuda):
    """D = 65800: distances past 2^24 (0 against 255: 16779000, tied over the
    whole library), and one row of the ragged last tile one lower wins."""
    d = 65800
    blocks = torch.zeros((3, d), dtype=torch.uint8, device=cuda)
    lib = torch.full((300, d), 255, dtype=torch.uint8, device=cuda)
    dist, row = distance.l1_argmin(blocks, lib)
    torch.cuda.synchronize()
    assert bool((dist == 255 * d).all()) and bool((row == 0).all())
    lib[290, 7] = 254
    dist, row = distance.l1_argmin(blocks, lib)
    torch.cuda.synchronize()
    assert bool((dist == 255 * d - 1).all()) and bool((row == 290).all())


def _k3_case(rng, b, l, d, m, dev, cand):
    blocks, lib = _u8(rng, (b, d), dev), _u8(rng, (l, d), dev)
    c = torch.from_numpy(np.ascontiguousarray(cand, dtype=np.int32)).to(dev)
    before = L1_ROWS.launches
    got = distance.l1_rows(blocks, c, lib)
    torch.cuda.synchronize()
    assert L1_ROWS.launches == before + 1
    assert torch.equal(got, distance._l1_rows_ref(blocks, c, lib))


@pytest.mark.parametrize(
    "b,l,d,m",
    [(5, 300, 3, 64), (37, 500, 12, 100), (40, 1000, 48, 64), (37, 900, 768, 1024),
     (33, 2000, 3072, 1024), (17, 300, 3072, 1), (40, 3000, 3072, 2000), (3, 64, 49152, 7),
     (9, 100, 49152, 300)],
)
def test_k3_unsorted_repeated_clamped(cuda, b, l, d, m):
    """Both paths (`_k3_plan`): candidates in no order, repeated within and
    across queries, and out of range (clamped); b not a multiple of the
    group, so the last group is ragged; m past one pass of the sort."""
    rng = np.random.default_rng(b * 7 + d + m)
    cand = rng.integers(-3, l + 3, size=(b, m))
    cand[:, 1::5] = cand[:, :1]
    cand[1::2, : m // 2] = cand[0, : m // 2]
    _k3_case(rng, b, l, d, m, cuda, cand)


@pytest.mark.parametrize("d", [3, 48, 768, 3072])
def test_k3_no_overlap_and_full_overlap(cuda, d):
    """Groups whose queries list disjoint rows, and groups whose queries all
    list the same rows (each in its own order)."""
    rng = np.random.default_rng(d)
    b, m = 40, 128
    disjoint = np.arange(b * m).reshape(b, m)
    _k3_case(rng, b, b * m, d, m, cuda, disjoint)
    rows = rng.choice(5000, m, replace=False)
    same = np.stack([rows[rng.permutation(m)] for _ in range(b)])
    _k3_case(rng, b, 5000, d, m, cuda, same)


def test_k3_past_4gib_grouped(cuda):
    """A 4.6 GB library, candidates past the 4 GiB byte offset, the grouped
    path."""
    rng = np.random.default_rng(46)
    l, d = 1_500_000, 3072
    lib = torch.randint(0, 256, (l, d), dtype=torch.uint8, device=cuda)
    blocks = _u8(rng, (20, d), cuda)
    first = (1 << 32) // d + 1
    cand = torch.from_numpy(rng.integers(first, l, size=(20, 64)).astype(np.int32)).to(cuda)
    cand[:, 0] = l - 1
    assert distance._k3_plan(64, d // 16)[0] > 0
    assert torch.equal(distance.l1_rows(blocks, cand, lib), distance._l1_rows_ref(blocks, cand, lib))


@pytest.mark.parametrize(
    "t,ts,nby,nbx", [(5, 8, 3, 128), (9, 12, 2, 37), (4, 20, 2, 3), (6, 16, 1, 200)]
)
def test_k2_matches_plain(cuda, t, ts, nby, nbx):
    rng = np.random.default_rng(t * 31 + ts)
    aug, _ = composite.augment_stack2d(_u8(rng, (t, ts, ts, 3), cuda), device=cuda)
    items = rng.integers(-t, t + 1, size=(nby, nbx)).astype(np.int32)
    items.reshape(-1)[:6] = [0, t, -t, t + 5, -(t + 5), 1]
    it = torch.from_numpy(items).to(cuda)
    before = COMPOSE.launches
    got = composite.compose_rows(it, aug)
    torch.cuda.synchronize()
    assert COMPOSE.launches == before + 1
    assert torch.equal(got, composite.compose_rows_ref(it, aug))


@pytest.mark.parametrize(
    "b,l,d,m",
    [(3, 50, 3, 1), (5, 300, 12, 7), (4, 1000, 48, 64), (9, 700, 192, 33),
     (6, 900, 768, 1024), (33, 2000, 3072, 64), (2, 64, 49152, 7), (17, 400, 75, 5)],
)
def test_k3_matches_plain(cuda, b, l, d, m):
    rng = np.random.default_rng(b * 13 + d)
    blocks, lib = _u8(rng, (b, d), cuda), _u8(rng, (l, d), cuda)
    cand = rng.integers(0, l + 3, size=(b, m)).astype(np.int32)  # past L clamps
    cand[0, 0], cand[-1, -1] = 0, l - 1
    c = torch.from_numpy(cand).to(cuda)
    before = L1_ROWS.launches
    got = distance.l1_rows(blocks, c, lib)
    torch.cuda.synchronize()
    assert L1_ROWS.launches == before + 1
    assert torch.equal(got, distance._l1_rows_ref(blocks, c, lib))


def test_k3_repeated_candidates_and_adaptive_scorer(cuda):
    """Repeated candidates, and the adaptive scorer on the card (K3 in its
    rescore) equal to the same scorer on the CPU."""
    rng = np.random.default_rng(11)
    bases = rng.integers(0, 256, size=(40, 48))
    lib = np.clip(np.repeat(bases, 250, axis=0) + rng.integers(-5, 6, (10000, 48)), 0, 255)
    lib = lib.astype(np.uint8)
    blocks = np.clip(lib[rng.integers(0, 10000, 300)].astype(int) + rng.integers(-3, 4, (300, 48)), 0, 255)
    blocks = blocks.astype(np.uint8)
    before = L1_ROWS.launches
    got = distance.l1_topk_adaptive(torch.from_numpy(blocks).to(cuda), torch.from_numpy(lib).to(cuda), 8)
    assert L1_ROWS.launches > before
    want = distance.l1_topk_adaptive(torch.from_numpy(blocks), torch.from_numpy(lib), 8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    c = torch.zeros((4, 100), dtype=torch.int32, device=cuda)
    t = _u8(rng, (10, 48), cuda)
    q = _u8(rng, (4, 48), cuda)
    assert torch.equal(distance.l1_rows(q, c, t), distance._l1_rows_ref(q, c, t))


def _stripe(rng, r, nseg, dev, hi=2**30):
    """A segment-major stripe with full-tie segments, values near 2^30, and
    the coarse pass's cols layout."""
    lp = nseg * 128
    dist = rng.integers(0, hi, size=(r, lp)).astype(np.int32)
    dist[:, :128] = 5  # a full-tie segment
    dist[:, 128 : 128 + 64 : 2] = hi - 1
    pos = np.arange(lp)
    cols = (pos % 128) * nseg + pos // 128
    return torch.from_numpy(dist).to(dev), torch.from_numpy(cols).to(dev)


@pytest.mark.parametrize(
    "r,nseg,cap,hi", [(3, 1, 8, 50), (5, 7, 16, 2**30), (17, 512, 16, 2**24), (4, 1563, 8, 30),
                      (2, 15625, 8, 2**20), (9, 3, 128, 7)]
)
def test_k4_matches_plain(cuda, r, nseg, cap, hi):
    rng = np.random.default_rng(r * 31 + nseg)
    dist, cols = _stripe(rng, r, nseg, cuda, hi)
    real_l = nseg * 128 - 40  # masked padding columns
    before = SEG_TOPCAP.launches
    got = distance.seg_topcap(dist, cols, cap, real_l)
    torch.cuda.synchronize()
    assert SEG_TOPCAP.launches == before + 1
    assert torch.equal(got, distance._seg_topcap_ref(dist, cols, cap, real_l))


def test_k4_tool_contract_and_the_coarse_pass(cuda):
    """`seg_topk` at the tool's [32, 130, 128] case, and the adaptive
    coarse pass on the card (K4 in it) equal to the same pass on the CPU."""
    rng = np.random.default_rng(130)
    seg = rng.integers(0, 50, size=(32, 130, 128)).astype(np.int32)
    seg[0, 0, :] = 7
    seg[1, 3, 10:] = distance._TL_BIG
    for cap in (8, 16):
        got = distance.seg_topk(torch.from_numpy(seg).to(cuda), cap)
        want = distance.seg_topk(torch.from_numpy(seg), cap)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    d, g, l = 96, 8, 3000
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    lib_pad = np.zeros((-(-l // 128) * 128, d), np.uint8)
    lib_pad[:l] = lib
    blocks = lib[rng.integers(0, l, size=40)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cl = distance._ad_coarse_lib(torch.from_numpy(lib_pad).to(dev), d, g, True, l)
        before = COARSE_TOPCAP.launches
        keys, s_min = distance._ad_coarse(torch.from_numpy(blocks).to(dev), cl, d, g, True, 16)
        assert COARSE_TOPCAP.launches == before + (dev.type == "cuda")
        outs.append((keys.cpu(), s_min.cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("cap", [1, 2, 5, 16, 32, 33, 128])
def test_k4_tie_storms_and_padding(cuda, cap):
    """Whole segments of one value, pairs of values, values past 2^24 (the
    rank path) and a padded suffix, at caps on every path of the kernel."""
    rng = np.random.default_rng(cap)
    nseg, r = 9, 6
    dist, cols = _stripe(rng, r, nseg, cuda, hi=3)
    dist[1] = 4  # a storm over the whole row
    dist[2, 128 * 3 : 128 * 4] = 2**24 + 5  # one segment past the u32 keys
    dist[3, ::2] = 2**30 - 1
    for real_l in (nseg * 128, nseg * 128 - 1, nseg * 128 - 200):
        got = distance.seg_topcap(dist, cols, cap, real_l)
        torch.cuda.synchronize()
        assert torch.equal(got, distance._seg_topcap_ref(dist, cols, cap, real_l))


def _coarse_case(rng, l, d, g, dev, kind, rows=70):
    """(projected blocks, coarse library) on dev: a library of l rows with
    a ragged last segment; "storm" repeats 3 rows over the whole library
    (ties everywhere, across segments), "clustered" is 20 centres +-3."""
    lp = -(-l // 128) * 128
    if kind == "storm":
        lib = rng.integers(0, 256, size=(3, d))[rng.integers(0, 3, size=l)]
    else:
        c = rng.integers(0, 256, size=(20, d))
        lib = np.clip(c[rng.integers(0, 20, size=l)] + rng.integers(-3, 4, (l, d)), 0, 255)
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    blocks = np.clip(lib[rng.integers(0, l, size=rows)] + rng.integers(-2, 3, (rows, d)), 0, 255)
    cl = distance._ad_coarse_lib(torch.from_numpy(lib_pad).to(dev), d, g, True, l)
    xp = distance._ad_project(torch.from_numpy(blocks.astype(np.uint8)).to(dev), d, g, True)
    return xp, cl


# K9's persistent grid, its ring of 16-coordinate stages and its two teams:
# (library rows, D, g, query rows) with dout 6, 27, 24, 384, 1536 and 96;
# one item, three items (fewer than the SMs), and 471 items (not a multiple
# of the SMs: blocks of several items, both teams, the ring wrapping);
# ragged rows and a ragged real_l in every case.
_K9_CASES = [(100, 48, 8, 70), (900, 108, 4, 70), (3000, 768, 32, 70), (700, 12288, 32, 70),
             (300, 49152, 32, 5), (20000, 3072, 32, 300)]


@pytest.mark.parametrize("kind", ["storm", "clustered"])
@pytest.mark.parametrize("cap", [1, 8, 16, 32, 33, 100])
@pytest.mark.parametrize("l,d,g,rows", _K9_CASES)
def test_k9_matches_plain(cuda, kind, cap, l, d, g, rows):
    rng = np.random.default_rng(l + cap)
    xp, cl = _coarse_case(rng, l, d, g, cuda, kind, rows)
    nseg = cl[0].shape[0]
    keys = torch.empty((xp.shape[0], nseg * cap), dtype=torch.int64, device=cuda)
    s_min = torch.empty((xp.shape[0],), dtype=torch.int32, device=cuda)
    before = COARSE_TOPCAP.launches
    distance.coarse_topcap(xp, cl, cap, keys, s_min)
    torch.cuda.synchronize()
    assert COARSE_TOPCAP.launches == before + 1
    wk, ws = distance._coarse_topcap_ref(xp, cl[0], cl[1], cap, cl[2])
    assert torch.equal(keys, wk) and torch.equal(s_min, ws)


def test_k9_refuses_a_plan_that_does_not_match(cuda):
    import ctypes

    rng = np.random.default_rng(9)
    xp, (proj, cols, real_l) = _coarse_case(rng, 1000, 48, 8, cuda, "clustered", 300)
    nseg, dout = proj.shape[0], proj.shape[1]
    keys = torch.empty((300, nseg * 8), dtype=torch.int64, device=cuda)
    s_min = torch.full((300,), 2**31 - 1, dtype=torch.int32, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rpad, items, grid, steps = distance._k9_plan(300, nseg, dout, sms)
    xt = torch.zeros((dout, rpad), dtype=torch.float32, device=cuda)
    xt[:, :300] = xp.t()
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    p = [ctypes.c_void_p(a.data_ptr()) for a in (xt, proj, cols, keys, s_min)]
    head = (300, rpad, dout, nseg, 8, real_l, distance._TL_BIG)
    for bad in ((items + 1, grid, steps, distance._K9_SMEM),
                (items, grid + 1, steps, distance._K9_SMEM),
                (items, grid, steps + 1, distance._K9_SMEM),
                (items, grid, steps, distance._K9_SMEM - 16)):
        with pytest.raises(RuntimeError, match="coarse_topcap kernel launch failed"):
            COARSE_TOPCAP.launch(0, *p, *head, *bad, stream)
    COARSE_TOPCAP.launch(0, *p, *head, items, grid, steps, distance._K9_SMEM, stream)
    torch.cuda.synchronize()
    wk, ws = distance._coarse_topcap_ref(xp, proj, cols, 8, real_l)
    assert torch.equal(keys, wk) and torch.equal(s_min, ws)


@pytest.mark.parametrize(
    "d,r,l",
    [(d, r, l) for d in (3, 12, 48, 768, 3072) for r, l in ((1, 1), (130, 300), (257, 1000))]
    + [(49152, 130, 300)],
)
def test_k10_stripe_matches_plain(cuda, d, r, l):
    """K10's stripe entry (`l1_block` on u8 rows) against `_l1_block_ref`:
    rows and library rows not multiples of 128, D not a multiple of 16."""
    rng = np.random.default_rng(d + r + l)
    x, t = _u8(rng, (r, d), cuda), _u8(rng, (l, d), cuda)
    before = L1_STRIPE.launches
    got = distance.l1_block(x, t)
    torch.cuda.synchronize()
    assert L1_STRIPE.launches == before + 1
    assert torch.equal(got, distance._l1_block_ref(x, t))


def _k10_case(rng, kind, r, l, d, dev):
    if kind == "storm":  # four distinct rows: every segment's cap cuts a tie
        t = torch.from_numpy(np.tile(rng.integers(0, 256, size=(4, d), dtype=np.uint8),
                                     (-(-l // 4), 1))[:l]).to(dev)
    else:
        t = _u8(rng, (l, d), dev)
    x = _u8(rng, (r, d), dev)
    x[0] = t[l // 2]
    return x, t


@pytest.mark.parametrize("cap", [1, 2, 5, 8, 16, 31, 32, 33])
@pytest.mark.parametrize("kind", ["uniform", "storm"])
@pytest.mark.parametrize("d", [3, 12, 48, 768, 3072])
def test_k10_topcap_matches_plain(cuda, cap, kind, d):
    """K10's fused entry against `_l1_topcap_ref`, bit for bit: a padded
    last segment (L = 1000), 130 query rows."""
    rng = np.random.default_rng(cap * 7 + d)
    x, t = _k10_case(rng, kind, 130, 1000, d, cuda)
    before = L1_TOPCAP.launches
    got = distance.l1_topcap(x, t, cap)
    torch.cuda.synchronize()
    assert L1_TOPCAP.launches == before + 1
    assert torch.equal(got, distance._l1_topcap_ref(x, t, cap, 0, 1000))


@pytest.mark.parametrize("col0,real_l", [(0, 700), (1000, 1200), (4096, 10**6), (128, 128)])
def test_k10_topcap_col0_and_real_l(cuda, col0, real_l):
    """A shard's global cols (col0 > 0) and padding from real_l inside it,
    in the middle of a segment or before the shard's first row."""
    rng = np.random.default_rng(col0)
    x, t = _k10_case(rng, "uniform", 300, 640, 48, cuda)
    for cap in (8, 16, 40):
        got = distance.l1_topcap(x, t, cap, col0=col0, real_l=real_l)
        assert torch.equal(got, distance._l1_topcap_ref(x, t, cap, col0, real_l))


def test_k10_wide_rows_take_the_rank_path(cuda):
    """Distances past 2^24 (D = 65800, all-0 queries against all-255 rows):
    the exact rank path, ties over the whole library, lowest col first."""
    x = torch.zeros((3, 65800), dtype=torch.uint8, device=cuda)
    t = torch.full((300, 65800), 255, dtype=torch.uint8, device=cuda)
    t[290, 7] = 254
    got = distance.l1_topcap(x, t, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, distance._l1_topcap_ref(x, t, 8, 0, 300))
    assert int(got[0, 2, 0] >> 32) == 255 * 65800 - 1 and int(got[0, 2, 0] & 0xFFFFFFFF) == 290


# K10's persistent grid and its ring of 64-word stages: fewer tiles than
# SMs, tile counts that are not a multiple of the SMs, ragged rows and
# library, and D that is not a multiple of the stage (a short last chunk).
_K10_EDGES = [(1, 1), (130, 1000), (257, 129 * 128 + 5), (1000, 4000), (2100, 2200)]


@pytest.mark.parametrize("d", [3, 48, 3088])
@pytest.mark.parametrize("r,l", _K10_EDGES)
def test_k10_stripe_persistent_edges(cuda, r, l, d):
    rng = np.random.default_rng(r + l + d)
    x, t = _u8(rng, (r, d), cuda), _u8(rng, (l, d), cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles = distance._k10_plan(r, l, d, sms)[2]
    assert (tiles < sms) == ((r, l) in _K10_EDGES[:2])
    got = distance.l1_block(x, t)
    torch.cuda.synchronize()
    assert torch.equal(got, distance._l1_block_ref(x, t))


@pytest.mark.parametrize("cap", [1, 8, 16, 32, 33])
@pytest.mark.parametrize("d", [3, 48, 3088])
@pytest.mark.parametrize("r,l", _K10_EDGES[1:])
def test_k10_topcap_persistent_edges(cuda, r, l, d, cap):
    rng = np.random.default_rng(r + l + d + cap)
    x, t = _k10_case(rng, "uniform", r, l, d, cuda)
    got = distance.l1_topcap(x, t, cap, col0=77, real_l=77 + l - 3)
    torch.cuda.synchronize()
    assert torch.equal(got, distance._l1_topcap_ref(x, t, cap, 77, 77 + l - 3))


@pytest.mark.parametrize("cap", [1, 8, 16, 32, 33])
def test_k10_topcap_tie_storm_across_the_pair(cuda, cap):
    """Every library row equal, or two values alternating, so each kept
    list ties across the two threads' halves of a segment: the lowest cols
    first, from both halves in turn."""
    rng = np.random.default_rng(cap)
    x = _u8(rng, (200, 48), cuda)
    row = _u8(rng, (1, 48), cuda)
    for t in (row.repeat(1000, 1), torch.cat([row, 255 - row]).repeat(500, 1)):
        got = distance.l1_topcap(x, t, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, distance._l1_topcap_ref(x, t, cap, 0, 1000))


def test_k10_entries_refuse_a_plan_that_does_not_match(cuda):
    import ctypes

    x = torch.zeros((300, 64), dtype=torch.uint8, device=cuda)
    out = torch.empty((300, 300), dtype=torch.int32, device=cuda)
    keys = torch.empty((300, 3, 8), dtype=torch.int64, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dw, ntq, tiles, grid = distance._k10_plan(300, 300, 64, sms)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    p = [ctypes.c_void_p(a.data_ptr()) for a in (x, x, out)]
    for bad in ((tiles + 1, grid, distance._K10_STRIPE_SMEM),
                (tiles, grid + 1, distance._K10_STRIPE_SMEM),
                (tiles, grid, distance._K10_STRIPE_SMEM - 16)):
        with pytest.raises(RuntimeError, match="l1_stripe kernel launch failed"):
            L1_STRIPE.launch(0, *p, 300, 300, dw, ntq, *bad, stream)
    p[2] = ctypes.c_void_p(keys.data_ptr())
    with pytest.raises(RuntimeError, match="l1_topcap kernel launch failed"):
        L1_TOPCAP.launch(0, *p, 300, 300, dw, ntq, tiles, grid, 8, 0, 300, 2**31 - 1,
                         distance._K10_STRIPE_SMEM, stream)
    L1_TOPCAP.launch(0, *p, 300, 300, dw, ntq, tiles, grid, 8, 0, 300, 2**31 - 1,
                     distance._K10_TOPCAP_SMEM, stream)
    torch.cuda.synchronize()
    assert torch.equal(keys, distance._l1_topcap_ref(x, x, 8, 0, 300))


def test_k10_routes_equal_the_cpu(cuda):
    """The two-level scorer (K10's fused entry, then the stripe fallback on
    K10's stripe) and the mesh's stripe top-k on a virtual card mesh equal
    the CPU's results."""
    from emosaic_tpu_torch.parallel import make_mesh, sharded_l1_topk

    rng = np.random.default_rng(10)
    lib = rng.integers(0, 256, size=(3000, 48), dtype=np.uint8)
    base = rng.integers(0, 256, size=48)
    lib[1100:1140] = np.clip(base + rng.integers(-2, 3, (40, 48)), 0, 255)
    blocks = rng.integers(0, 256, size=(200, 48), dtype=np.uint8)
    blocks[:50] = np.clip(base + rng.integers(-2, 3, (50, 48)), 0, 255)
    before = (L1_TOPCAP.launches, L1_STRIPE.launches)
    got = distance.l1_topk_twolevel(blocks, lib, 16, device=cuda)
    assert L1_TOPCAP.launches > before[0] and L1_STRIPE.launches > before[1]
    want = distance.l1_topk_twolevel(blocks, lib, 16, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    mesh = make_mesh(4, model=2, devices=[cuda] * 4)
    before = L1_TOPCAP.launches
    got = sharded_l1_topk(torch.from_numpy(blocks).to(cuda), torch.from_numpy(lib).to(cuda),
                          16, mesh)
    assert L1_TOPCAP.launches == before + 4
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("d", [12, 48, 3072])
def test_l1_argmin_stripes_on_k10_equals_k1(cuda, d):
    """The JAX package's stripe argmin under its name, on K10's stripe: the
    same (distance, lowest row) as K1, on a library with repeated rows."""
    rng = np.random.default_rng(d)
    lib = _u8(rng, (700, d), cuda).repeat(3, 1)
    blocks = _u8(rng, (300, d), cuda)
    blocks[:10] = lib[:10]
    before = L1_STRIPE.launches
    got = distance.l1_argmin_stripes(blocks, lib)
    assert L1_STRIPE.launches > before
    want = distance.l1_argmin(blocks, lib)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# K11 (`csrc/l2_score.cu`): the squared-L2 argmin and the per-segment
# top-cap on the tensor cores, bit for bit against their plain versions:
# D padded to 32 bytes (3, 12, 48, 192), the argmin's packed key at its
# widest rows (128) and the (dist^2, col) compare past it (129 to 4160),
# the split depth (49152), odd L, duplicated rows and tie storms; the
# top-cap's caps from the 32 group minima and above them (the whole
# segment ranked).


def _k11_lib(rng, kind, l, d, dev):
    if kind == "storm":  # four distinct rows: every cut falls in a tie
        return torch.from_numpy(np.tile(rng.integers(0, 256, size=(4, d), dtype=np.uint8),
                                        (-(-l // 4), 1))[:l]).to(dev)
    t = _u8(rng, (l, d), dev)
    if kind == "duplicates":
        t[l // 2 :] = t[: l - l // 2].clone()
    return t


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "storm"])
@pytest.mark.parametrize(
    "r,l,d", [(1, 1, 3), (130, 301, 12), (257, 1001, 48), (300, 513, 192), (33, 777, 768),
              (100, 601, 3072), (40, 300, 4128), (40, 300, 4160), (20, 257, 49152),
              (70, 901, 128), (70, 901, 129),
              (5000, 3001, 48)])
def test_k11_argmin_matches_plain(cuda, kind, r, l, d):
    rng = np.random.default_rng(r + l + d)
    t = _k11_lib(rng, kind, l, d, cuda)
    x = _u8(rng, (r, d), cuda)
    x[0] = t[l // 2]
    before = L2_ARGMIN.launches
    got = distance._l2_argmin(x, t)
    torch.cuda.synchronize()
    assert L2_ARGMIN.launches == before + 1
    want = distance._l2_argmin_ref(x, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k11_argmin_extremes_and_wrap(cuda):
    """dist^2 at its extremes: all-0 queries against all-255 rows at the
    packed key's widest rows (128), at 4128 bytes and past 2^31 (D =
    40000, the int32 wrap)."""
    for d in (128, 4128, 40000):
        x = torch.zeros((3, d), dtype=torch.uint8, device=cuda)
        x[1] = 255
        t = torch.full((300, d), 255, dtype=torch.uint8, device=cuda)
        t[200, :5] = 0
        got, want = distance._l2_argmin(x, t), distance._l2_argmin_ref(x, t)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[1][0]) == 200 and int(got[1][1]) == 0


@pytest.mark.parametrize("cap", [1, 7, 16, 24, 32, 33, 128])
@pytest.mark.parametrize("seg", [128, 256, 512, 1024])
@pytest.mark.parametrize("kind", ["uniform", "storm"])
@pytest.mark.parametrize("d", [12, 48, 192, 768, 3072])
def test_k11_topcap_matches_plain(cuda, cap, seg, kind, d):
    """K11's fused entry against `_l2_topcap_ref`, bit for bit: a padded
    last segment (L = 3001), 70 query rows; caps above 32 rank the whole
    segment (128: a 128-row segment kept whole)."""
    rng = np.random.default_rng(cap * 7 + seg + d)
    t = _k11_lib(rng, kind, 3001, d, cuda)
    x = _u8(rng, (70, d), cuda)
    x[0] = t[1500]
    before = L2_TOPCAP.launches
    got = distance.l2_topcap(x, t, cap, seg=seg)
    torch.cuda.synchronize()
    assert L2_TOPCAP.launches == before + 1
    assert torch.equal(got, distance._l2_topcap_ref(x, t, cap, seg, 0, 3001))


@pytest.mark.parametrize("col0,real_l", [(0, 700), (1000, 1200), (4096, 10**6), (128, 128)])
def test_k11_topcap_col0_and_real_l(cuda, col0, real_l):
    rng = np.random.default_rng(col0)
    t = _k11_lib(rng, "duplicates", 900, 48, cuda)
    x = _u8(rng, (100, 48), cuda)
    for seg, cap in ((128, 8), (256, 16), (1024, 32), (128, 77), (256, 256)):
        got = distance.l2_topcap(x, t, cap, seg=seg, col0=col0, real_l=real_l)
        assert torch.equal(got, distance._l2_topcap_ref(x, t, cap, seg, col0, real_l))


def test_k11_topcap_split_depth(cuda):
    """Rows past 33024 bytes: the split depth and the keys' 2^31 bias,
    with distances past 2^31 kept (bright rows against a zero query)."""
    rng = np.random.default_rng(49152)
    t = torch.from_numpy(rng.integers(215, 256, size=(300, 49152), dtype=np.uint8)).to(cuda)
    x = _u8(rng, (40, 49152), cuda)
    x[0] = 0
    x[1] = t[7]
    got = distance.l2_topcap(x, t, 8, seg=128)
    torch.cuda.synchronize()
    assert torch.equal(got, distance._l2_topcap_ref(x, t, 8, 128, 0, 300))
    assert int(got[0, 0, 0] >> 32) > 0 and int(got[1, 0, 0] >> 32) == -(2**31)


def test_k11_entries_refuse_a_plan_that_does_not_match(cuda):
    import ctypes

    x = torch.zeros((300, 64), dtype=torch.uint8, device=cuda)
    n = torch.zeros(300, dtype=torch.int32, device=cuda)
    keys = torch.full((300,), -1, dtype=torch.int64, device=cuda)
    out = torch.empty((300, 3, 8), dtype=torch.int64, device=cuda)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    p = [ctypes.c_void_p(a.data_ptr()) for a in (x, x, n, n, keys)]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dp, nqt, nsplit, tps = distance._k11_argmin_plan(300, 300, 64, sms)
    for bad in ((300, 300, dp, nqt + 1, nsplit, tps, distance._K11_ARG_SMEM),
                (300, 300, 48, nqt, nsplit, tps, distance._K11_ARG_SMEM),
                (300, 300, dp, nqt, nsplit + 1, tps, distance._K11_ARG_SMEM),
                (300, 300, dp, nqt, nsplit, tps, distance._K11_ARG_SMEM - 16)):
        with pytest.raises(RuntimeError, match="l2_argmin kernel launch failed"):
            L2_ARGMIN.launch(0, *p, *bad, stream)
    p[4] = ctypes.c_void_p(out.data_ptr())
    smem = distance._k11_topcap_smem(128)
    nqt = -(-300 // 256)
    for bad in ((128, 8, 0, 300, 0, nqt, nqt * 3, smem - 16),
                (128, 129, 0, 300, 0, nqt, nqt * 3, smem),
                (128, 8, 0, 300, 2**31, nqt, nqt * 3, smem),
                (128, 8, 0, 301, 0, nqt, nqt * 3, smem),
                (100, 8, 0, 300, 0, nqt, nqt * 3, smem)):
        with pytest.raises(RuntimeError, match="l2_topcap kernel launch failed"):
            L2_TOPCAP.launch(0, *p, 300, 300, 64, *bad, stream)
    L2_TOPCAP.launch(0, *p, 300, 300, 64, 128, 8, 0, 300, 0, nqt, nqt * 3, smem, stream)
    torch.cuda.synchronize()
    assert torch.equal(out, distance._l2_topcap_ref(x, x, 8, 128, 0, 300))


def test_k11_routes_equal_the_cpu(cuda, monkeypatch):
    """`l2_argmin` and the hybrid (`l1_topk_hybrid`: K11's top-cap as the
    prefilter's stage 1, whole segments for uncertified rows, K3's
    rescore) on the card equal the CPU's results; with a cap too small for
    runs of near rows, the fallback rows too."""
    rng = np.random.default_rng(11)
    lib = rng.integers(0, 256, size=(9000, 48), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(300, 48), dtype=np.uint8)
    before = (L2_ARGMIN.launches, L2_TOPCAP.launches)
    got = distance.l2_argmin(blocks, lib, device=cuda)
    want = distance.l2_argmin(blocks, lib, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got = distance.l1_topk_hybrid(blocks, lib, 4, device=cuda)
    assert L2_ARGMIN.launches == before[0] + 1 and L2_TOPCAP.launches > before[1]
    want = distance.l1_topk_hybrid(blocks, lib, 4, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    near = np.clip(blocks[:20, None].astype(int) + rng.integers(-2, 3, (20, 30, 48)), 0, 255)
    for i in range(20):
        lib[128 * i : 128 * i + 30] = near[i]
    monkeypatch.setattr(distance, "_k11_topcap_plan", lambda l, k: (128, 3))
    x, t = torch.from_numpy(blocks), torch.from_numpy(lib)
    got = distance._l2_prefilter(x.to(cuda), t.to(cuda), 8)
    assert torch.equal(got.cpu(), distance._l2_prefilter(x, t, 8))


@pytest.mark.parametrize("l,k_pre", [(20000, 1024), (4000, 1024), (1100, 1024), (300, 64)])
def test_k11_prefilter_past_every_fast_plan(cuda, l, k_pre):
    """k_pre too large a share of the library for a fast plan: 128-row
    segments with a cap of the group minima (20000 rows), ranked whole
    segments (4000, 300) or segments kept whole (1100), on K11 alone, equal
    to the CPU's."""
    rng = np.random.default_rng(l)
    t = torch.from_numpy(rng.integers(0, 256, size=(l, 48), dtype=np.uint8))
    x = torch.from_numpy(rng.integers(0, 256, size=(200, 48), dtype=np.uint8))
    t[l // 2 :: 7] = t[0]
    before = L2_TOPCAP.launches
    got = distance._l2_prefilter(x.to(cuda), t.to(cuda), k_pre)
    assert L2_TOPCAP.launches > before
    assert torch.equal(got.cpu(), distance._l2_prefilter(x, t, k_pre))


@pytest.mark.parametrize("h,w", [(1, 16), (7, 13), (24, 6144), (3, 100003)])
def test_k5_matches_plain(cuda, h, w):
    seed = torch.full((8, 128), 200, dtype=torch.uint8, device=cuda)
    seed[0, 0] = 7
    before = FLOOR_WRITE.launches
    got = composite_lab.floor_write(seed, h, w)
    torch.cuda.synchronize()
    assert FLOOR_WRITE.launches == before + 1
    assert torch.equal(got, composite_lab.floor_write_ref(seed, h, w))


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize(
    "t,ts,nby,nbx,run", [(5, 8, 3, 128, None), (40, 16, 2, 77, 5), (9, 24, 2, 300, None),
                         (30, 32, 3, 129, 32), (7, 64, 1, 40, 2)]
)
def test_k6_k7_match_plain(cuda, stages, t, ts, nby, nbx, run):
    rng = np.random.default_rng(t * 17 + ts + stages)
    aug, _ = composite.augment_stack2d(_u8(rng, (t, ts, ts, 3), cuda), device=cuda)
    items = rng.integers(-t - 3, t + 4, size=(nby, nbx)).astype(np.int32)
    items.reshape(-1)[:8] = [0, t, -t, t + 5, -(t + 5), 1, 2**31 - 1, -(2**31)]
    it = torch.from_numpy(items).to(cuda)
    kernel = COMPOSE_BULK if stages == 1 else COMPOSE_BULK2
    before = kernel.launches
    got = composite_lab.compose_rows_bulk(it, aug, stages=stages, run=run)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, composite_lab.compose_rows_bulk_ref(it, aug))
    assert torch.equal(got, composite.compose_rows(it, aug))


@pytest.mark.parametrize("ts,w,nby,nbx", [(8, 24, 3, 128), (16, 48, 2, 77), (32, 96, 2, 300),
                                          (64, 192, 1, 40), (3, 9, 2, 5)])
def test_k8_matches_plain(cuda, ts, w, nby, nbx):
    rng = np.random.default_rng(ts * 3 + nbx)
    sel = _u8(rng, (nby * nbx, ts, w), cuda)
    before = BAND_TRANSPOSE.launches
    got = composite_lab.band_transpose(sel, nby, nbx)
    torch.cuda.synchronize()
    assert BAND_TRANSPOSE.launches == before + 1
    assert torch.equal(got, composite_lab.band_transpose_ref(sel, nby, nbx))


def test_sharded_on_a_virtual_card_mesh(cuda):
    """A virtual mesh of four positions on the one card: the sharded argmin
    (K1 per shard) and the sharded adaptive scorer (K9 and K3 per shard)
    equal the single-device routes on the card."""
    from emosaic_tpu_torch.parallel import make_mesh, sharded_l1_argmin, sharded_l1_topk_adaptive

    rng = np.random.default_rng(21)
    mesh = make_mesh(4, model=2, devices=[cuda] * 4)
    blocks, lib = _u8(rng, (301, 48), cuda), _u8(rng, (2051, 48), cuda)
    lib[1500] = lib[3]  # a tie across the two library shards
    blocks[9] = lib[3]
    before = L1_ARGMIN.launches
    got = sharded_l1_argmin(blocks, lib, mesh)
    assert L1_ARGMIN.launches == before + 4
    want = distance.l1_argmin(blocks, lib)
    np.testing.assert_array_equal(got[0], want[0].cpu().numpy())
    np.testing.assert_array_equal(got[1], want[1].cpu().numpy())

    bases = rng.integers(0, 256, size=(40, 48))
    lib = np.clip(np.repeat(bases, 250, axis=0) + rng.integers(-5, 6, (10000, 48)), 0, 255)
    lib = torch.from_numpy(lib.astype(np.uint8)).to(cuda)
    pick = torch.from_numpy(rng.integers(0, 10000, 300)).to(cuda)
    noise = torch.from_numpy(rng.integers(-3, 4, (300, 48))).to(cuda)
    blocks = (lib[pick].int() + noise).clamp(0, 255).to(torch.uint8)
    mesh = make_mesh(4, devices=[cuda] * 4)
    before = (L1_ROWS.launches, COARSE_TOPCAP.launches)
    st = {}
    got = sharded_l1_topk_adaptive(blocks, lib, 8, mesh, stats=st)
    assert st["route"] == "adaptive" and L1_ROWS.launches > before[0]
    assert COARSE_TOPCAP.launches > before[1]
    want = distance.l1_topk_adaptive(blocks, lib, 8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _k12_check(blocks, ids, lib, used, k):
    before = MASKED_REFILL.launches
    got = refill.masked_refill(blocks, ids, lib, used, k)
    assert MASKED_REFILL.launches == before + 1
    torch.cuda.synchronize()
    want = refill._masked_refill_ref(blocks, ids, lib, used, k)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("m", ["1", "crossover", "above"])
def test_k12_matches_plain_at_the_cell_shape(cuda, m):
    """K12 at `generate_m32.photo`'s refill: 65534 rows of 3072 bytes,
    about 37k unused, k = 256, at one block, at the crossover and one
    above it (the kernel takes any M; the refiller sends it only up to the
    crossover); block 0 is a library row with 300 unused copies, so the
    256th place cuts a group of equal distances."""
    m = {"1": 1, "crossover": refill._K12_MAX_M, "above": refill._K12_MAX_M + 1}[m]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    l, d, k = 65534, 3072, 256
    lib = torch.randint(0, 256, (l, d), dtype=torch.uint8, device=cuda, generator=gen)
    blocks = torch.randint(0, 256, (4096, d), dtype=torch.uint8, device=cuda, generator=gen)
    used = (torch.rand(l, device=cuda, generator=gen) < 0.435).to(torch.uint8)
    copies = torch.randperm(l, device=cuda, generator=gen)[:300]
    lib[copies] = lib[7].clone()
    used[copies] = 0
    ids = torch.randperm(4096, device=cuda, generator=gen)[:m]
    blocks[ids[0]] = lib[7]
    got = _k12_check(blocks, ids, lib, used, k)
    same = ((lib == lib[7]).all(1) & (used == 0)).nonzero().flatten()
    assert len(same) >= 300 and (got[0, 0] == 0).all() and torch.equal(got[1, 0], same[:k].int())
    refiller = refill.DeviceRefiller(blocks, lib, k=k)
    dd, dr = refiller(ids.cpu().numpy(), used.cpu().numpy())
    torch.cuda.synchronize()
    np.testing.assert_array_equal(dd, got[0].cpu().numpy())
    np.testing.assert_array_equal(dr, got[1].cpu().numpy())
    assert refiller.n_fused == int(m <= refill._K12_MAX_M)


@pytest.mark.parametrize("l,d", [(1034, 24), (1, 3), (129, 48), (5000, 3088), (300, 4112)])
def test_k12_matches_plain_at_edges(cuda, l, d):
    """Ragged libraries and rows that are not whole 16-byte vectors, and
    rows past 4096 bytes (read again for each pass of blocks); masks
    with none, all, fewer than k and one row unused; k from 1 to the
    selection's largest; tie storms (one row repeated)."""
    rng = np.random.default_rng(l + d)
    lib, blocks = _u8(rng, (l, d), cuda), _u8(rng, (70, d), cuda)
    storm = lib[:1].repeat(l, 1)
    for m in (1, 3, 64):
        ids = torch.from_numpy(rng.choice(70, size=m, replace=False)).to(cuda)
        for frac in (0.0, 0.5, 1.0):
            used = torch.from_numpy((rng.random(l) < frac).astype(np.uint8)).to(cuda)
            for k in (1, 16, 256, refill._K12_MAX_K):
                _k12_check(blocks, ids, lib, used, k)
            _k12_check(blocks, ids, storm, used, 16)
        one = torch.ones(l, dtype=torch.uint8, device=cuda)
        one[l // 2] = 0
        _k12_check(blocks, ids, lib, one, 256)


def _k13_check(dist, dmax):
    """K13 against its plain version on the card, exactly, and the host
    lists `sorted_lists` makes of it against the stable numpy argsort."""
    before = ROW_SORT.launches
    got = distance.row_sort(dist, dmax)
    assert ROW_SORT.launches == before + 1
    torch.cuda.synchronize()
    want = distance._row_sort_ref(dist, dmax)
    assert got.shape == want.shape and torch.equal(got, want)
    return distance._k13_plan(dist.shape[1], dmax)


@pytest.mark.parametrize(
    "b,l,d,key_bytes,chunked",
    [(4096, 8192, 768, 4, False), (3051, 65534, 3072, 8, True), (300, 8191, 768, 4, False),
     (200, 12345, 3072, 8, False), (40, 12345, 48, 4, False), (30, 30001, 48, 4, True),
     (7, 20000, 3072, 8, True), (9, 1, 768, 4, False), (33, 5, 3, 4, False)],
)
def test_k13_matches_plain(cuda, b, l, d, key_bytes, chunked):
    """K13 on K10's distances of random rows: the `service_m16` cell's
    matrix (u32 keys, a row a block), the exact-full route's longest rows
    (L = 65534 at D = 3072 and its largest B: u64 keys, chunks merged
    through device memory), odd row lengths on both paths and both key
    widths (12345 u64 keys next to a block's shared-memory limit), one-entry
    rows."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b + l + d)
    x = torch.randint(0, 256, (b, d), dtype=torch.uint8, device=cuda, generator=gen)
    t = torch.randint(0, 256, (l, d), dtype=torch.uint8, device=cuda, generator=gen)
    dist = distance.l1_block(x, t)
    plan = _k13_check(dist, 255 * d)
    assert plan[0] == key_bytes and bool(plan[4]) == chunked
    if b * l <= 10**6:
        cd, cr = distance.sorted_lists(dist, 255 * d)
        m = dist.cpu().numpy()
        order = np.argsort(m, axis=1, kind="stable")
        np.testing.assert_array_equal(cr, order)
        np.testing.assert_array_equal(cd, np.take_along_axis(m, order, axis=1))


@pytest.mark.parametrize("l,d", [(8192, 768), (12345, 3072), (30001, 48), (20000, 3072)])
@pytest.mark.parametrize("values", [(0, 0), (0, 2), (7, 9)])
def test_k13_tie_storms(cuda, l, d, values):
    """Rows of one value and of three: every digit's keys stay in column
    order, on both paths and both key widths."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(l + values[1])
    lo, hi = values
    dist = torch.randint(lo, hi + 1, (16, l), dtype=torch.int32, device=cuda, generator=gen)
    _k13_check(dist, 255 * d)


@pytest.mark.parametrize("dmax,key_bytes", [((1 << 19) - 1, 4), (1 << 19, 8)])
def test_k13_key_width_boundary(cuda, dmax, key_bytes):
    """8192 columns (13 bits) and distances of 19 bits, the largest set:
    32-bit keys with the top bit set; one more distance bit: 64-bit keys."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(dmax)
    dist = torch.randint(dmax - 3, dmax + 1, (64, 8192), dtype=torch.int32, device=cuda,
                         generator=gen)
    assert _k13_check(dist, dmax)[0] == key_bytes


def test_k13_serves_the_exact_full_render(cuda):
    """One exact-full render on the card launches K13 once, says so in its
    counters, and gives the CPU render's items and image."""
    from emosaic_tpu_torch.render import norepeat
    from emosaic_tpu_torch.tiles.tileset import TileSet

    rng = np.random.default_rng(13)
    t, dim, side, ts = 256, 16, 16, 8
    bases = rng.integers(0, 256, size=(t, 1, 3))
    pal = np.clip(bases + rng.integers(-10, 11, size=(t, dim * dim, 3)), 0, 255).astype(np.uint8)
    src = rng.integers(0, 256, size=(side * dim, side * dim, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    tiles = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(t)])
    quiet = dict(stack=stack, log=lambda *a: None)
    before = ROW_SORT.launches
    got = norepeat.render_nto1_no_repeat(src, tiles, ts, device="cuda", **quiet)
    torch.cuda.synchronize()
    assert ROW_SORT.launches == before + 1
    assert got.info["scorer"] == "exact-full"
    assert got.info["scoring"]["sort"] == "k13" and got.info["scoring"]["key_bytes"] == 4
    want = norepeat.render_nto1_no_repeat(src, tiles, ts, device="cpu", **quiet)
    assert want.info["scoring"]["sort"] == "plain"
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(np.asarray(got.image), np.asarray(want.image))
