"""K1 to K10 against their plain torch versions on an NVIDIA GPU, and the
sharded routes of `parallel/` on a virtual mesh of the one card.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip
on a host without a GPU. This file imports neither jax nor the JAX
package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops import composite, composite_lab, distance
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


def _coarse_case(rng, l, d, g, dev, kind):
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
    blocks = np.clip(lib[rng.integers(0, l, size=70)] + rng.integers(-2, 3, (70, d)), 0, 255)
    cl = distance._ad_coarse_lib(torch.from_numpy(lib_pad).to(dev), d, g, True, l)
    xp = distance._ad_project(torch.from_numpy(blocks.astype(np.uint8)).to(dev), d, g, True)
    return xp, cl


@pytest.mark.parametrize("kind", ["storm", "clustered"])
@pytest.mark.parametrize("cap", [1, 8, 16, 100])
@pytest.mark.parametrize("l,d,g", [(100, 48, 8), (900, 108, 4), (3000, 768, 32),
                                   (700, 12288, 32)])
def test_k9_matches_plain(cuda, kind, cap, l, d, g):
    rng = np.random.default_rng(l + cap)
    xp, cl = _coarse_case(rng, l, d, g, cuda, kind)
    nseg = cl[0].shape[0]
    keys = torch.empty((xp.shape[0], nseg * cap), dtype=torch.int64, device=cuda)
    s_min = torch.empty((xp.shape[0],), dtype=torch.int32, device=cuda)
    before = COARSE_TOPCAP.launches
    distance.coarse_topcap(xp, cl, cap, keys, s_min)
    torch.cuda.synchronize()
    assert COARSE_TOPCAP.launches == before + 1
    wk, ws = distance._coarse_topcap_ref(xp, cl[0], cl[1], cap, cl[2])
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
