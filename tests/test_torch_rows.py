"""Port parity: the shortlist rescore (kernel K3's plain version) and the
adaptive scorer's stages against the JAX package.

`_l1_rows_ref` is the plain torch version of K3 (`csrc/l1_rows.cu`); it is
held against the Pallas kernel `_l1_rows_kernel` run through the Pallas
interpreter, exactly. The stages around it (`_ad_coarse`, `_ad_rescore`)
are held against `_ad_coarse_jit` and `_ad_rescore_jit` with the DMA
branch in interpret mode. K3 itself runs only on a GPU:
`tests/test_torch_gpu.py` holds it against `_l1_rows_ref`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as jax_distance
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import L1_ROWS


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "b,lp,d,m",
    [
        (4, 128, 48, 8),
        (9, 256, 128, 32),
        (16, 384, 256, 16),
        (6, 256, 768, 16),
    ],
)
def test_l1_rows_ref_matches_pallas_interpret(rng, b, lp, d, m):
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    libp = rng.integers(0, 256, size=(lp, d), dtype=np.uint8)
    cand = rng.integers(0, lp, size=(b, m)).astype(np.int32)
    cand[0, :3] = [0, lp - 1, 0]  # boundary + repeated rows
    mc = jax_distance._rows_dma_mc(m, d)
    want = jax_distance._l1_rows_dma(
        jnp.asarray(blocks), jnp.asarray(cand), jnp.asarray(libp),
        mc=mc, interpret=True,
    )
    got = distance.l1_rows(_t(blocks), _t(cand), _t(libp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [3, 12, 75, 192])
def test_l1_rows_ref_clamps_and_chunks(rng, monkeypatch, d):
    """Candidates past the library clamp to its last row (as the Pallas
    kernel's `min(cand, LP-1)`), at odd D, across the gather's chunks."""
    monkeypatch.setattr(distance, "_RESCORE_I32_BYTES", 1)  # one row per chunk
    b, l, m = 5, 40, 9
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    cand = rng.integers(0, l + 10, size=(b, m)).astype(np.int32)
    got = distance.l1_rows(_t(blocks), _t(cand), _t(lib)).numpy()
    rows = np.minimum(cand, l - 1)
    want = np.abs(blocks.astype(np.int64)[:, None, :] - lib.astype(np.int64)[rows]).sum(-1)
    np.testing.assert_array_equal(got, want)


def test_k3_wrapper_on_cpu_does_not_launch(rng):
    L1_ROWS.launches = 0
    blocks = _t(rng.integers(0, 256, size=(3, 48), dtype=np.uint8))
    lib = _t(rng.integers(0, 256, size=(20, 48), dtype=np.uint8))
    cand = _t(rng.integers(0, 20, size=(3, 4)).astype(np.int32))
    distance.l1_rows(blocks, cand, lib)
    assert L1_ROWS.launches == 0


def test_l1_rows_checks_its_inputs():
    u8 = torch.zeros((2, 3), dtype=torch.uint8)
    c = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        distance.l1_rows(u8.to(torch.int32), c, u8)
    with pytest.raises(TypeError):
        distance.l1_rows(u8, c.to(torch.int64), u8)
    with pytest.raises(ValueError):
        distance.l1_rows(u8, c, torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        distance.l1_rows(u8, c[:1], u8)
    with pytest.raises(ValueError, match="empty"):
        distance.l1_rows(u8, c, torch.zeros((0, 3), dtype=torch.uint8))


@pytest.mark.parametrize(
    "d,g,chan",
    [(48, 4, True), (128, 4, False), (96, 8, True), (3072, 32, True)],
)
def test_ad_project_matches_jax(rng, d, g, chan):
    x = rng.integers(0, 256, size=(7, d), dtype=np.uint8)
    want = np.asarray(jax_distance._ad_project(jnp.asarray(x), d, g, chan))
    got = distance._ad_project(_t(x), d, g, chan)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,g,chan,kind", [(48, 4, True, "random"), (128, 4, False, "random"),
                                          (48, 8, True, "dupes")])
def test_ad_stages_match_jax_dma_branch(rng, d, g, chan, kind):
    """The coarse survivors, s_min, and (dists, rows, ok) of the rescore
    with the DMA kernel in interpret mode, bit for bit."""
    b, l, cap, m, k = 16, 2000, 4, 32, 6
    lp = -(-l // 128) * 128
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    if kind == "dupes":
        lib[l // 2 :] = lib[: l - l // 2]  # cross-segment exact ties
    blocks = lib[rng.integers(0, l, size=b)]
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    bf = jnp.asarray(blocks.reshape(-1))
    lf = jnp.asarray(lib_pad.reshape(-1))
    vals, cols, s_min = jax_distance._ad_coarse_jit(
        bf, lf, d=d, g=g, chan=chan, bc=8, cap=cap, real_l=l
    )
    want = jax_distance._ad_rescore_jit(
        bf, vals, cols, s_min, lf, d=d, bc=8, m=m, k=k, real_l=l,
        use_dma=True, interpret=True,
    )
    coarse_lib = distance._ad_coarse_lib(_t(lib_pad), d, g, chan, l)
    keys, sm = distance._ad_coarse(_t(blocks), coarse_lib, d, g, chan, cap)
    np.testing.assert_array_equal((keys >> 32).numpy(), np.asarray(vals))
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), np.asarray(cols))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(s_min))
    got = distance._ad_rescore(_t(blocks), keys, sm, _t(lib_pad), m=m, k=k, real_l=l)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_ad_rescore_masks_padding_rows(rng):
    """Candidates at padding rows (>= real_l) carry I32_MAX and lose."""
    b, d, lp, real_l, m, k = 4, 48, 256, 250, 16, 5
    lib = rng.integers(0, 256, size=(lp, d), dtype=np.uint8)
    lib[real_l:] = 0
    blocks = lib[:b].copy()
    cols = np.stack([rng.permutation(lp)[:m] for _ in range(b)]).astype(np.int64)
    cols[:, 0] = real_l  # a padding row in every list
    bound = np.zeros((b, m), np.int64)
    bound[:, -1] = 10**6  # the first unselected survivor bounds the rest
    keys = torch.from_numpy((bound << 32) | np.sort(cols, axis=1))
    s_min = torch.full((b,), 10**6, dtype=torch.int32)
    dd, rr, ok = distance._ad_rescore(_t(blocks), keys, s_min, _t(lib), m=m - 1, k=k,
                                      real_l=real_l)
    assert (rr.numpy() < real_l).all()
    assert ok.all()
