"""K1, K2, K3 and K4 against their plain torch versions on an NVIDIA GPU.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip
on a host without a GPU. This file imports neither jax nor the JAX
package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops import composite, distance
from emosaic_tpu_torch.ops._kernels import COMPOSE, L1_ARGMIN, L1_ROWS, SEG_TOPCAP

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
        before = SEG_TOPCAP.launches
        keys, s_min = distance._ad_coarse(torch.from_numpy(blocks).to(dev), cl, d, g, True, 16)
        assert SEG_TOPCAP.launches == before + (dev.type == "cuda")
        outs.append((keys.cpu(), s_min.cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
