"""Port parity: `emosaic_tpu_torch.ops.distance` against the JAX package.

`l1_argmin` on CPU tensors runs the plain version of kernel K1; it is held
against the Pallas kernel in interpret mode and against the XLA oracle,
exactly (int32 distances and rows, lowest row on ties). K1 itself runs
only on a GPU: `tests/test_torch_gpu.py` holds it against this version.
"""

import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as jax_distance
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import L1_ARGMIN


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n_cells", [1, 4, 9])
def test_build_library_matches_jax(rng, n_cells):
    pal = rng.integers(0, 256, size=(7, n_cells, 3), dtype=np.uint8)
    want = np.asarray(jax_distance.build_library(pal))
    np.testing.assert_array_equal(distance.build_library(_t(pal)).numpy(), want)
    np.testing.assert_array_equal(
        distance.flip_palettes(_t(pal)).numpy(),
        np.asarray(jax_distance.flip_palettes(pal)),
    )


def test_rows_items_roundtrip_matches_jax():
    t = 9
    rows = np.arange(2 * t, dtype=np.int32)
    items = distance.rows_to_items(_t(rows), t).numpy()
    np.testing.assert_array_equal(
        items, np.asarray(jax_distance.rows_to_items(rows, t))
    )
    back = distance.items_to_rows(_t(items), t).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_distance.items_to_rows(items, t))
    )
    np.testing.assert_array_equal(back, rows)


@pytest.mark.parametrize(
    "b,l,d",
    [
        (1, 3, 3),  # tiny, heavy padding on every axis
        (5, 700, 12),  # l crosses one Pallas lib tile
        (300, 513, 12),  # b crosses a Pallas block tile
        (70, 100, 200),  # d crosses a Pallas d-chunk
        (40, 300, 192),  # mode 8
        (9, 40, 3072),  # mode 32
    ],
)
def test_l1_argmin_matches_pallas_and_xla(rng, b, l, d):
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    dist, row = distance.l1_argmin(_t(blocks), _t(lib))
    assert dist.dtype == row.dtype == torch.int32
    dp, rp = jax_distance._l1_argmin_pallas(blocks, lib, interpret=True)
    dx, rx = jax_distance.l1_argmin_xla(blocks, lib)
    for want_d, want_r in ((dp, rp), (dx, rx)):
        np.testing.assert_array_equal(dist.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(row.numpy(), np.asarray(want_r))


def test_l1_argmin_tie_storm_lowest_row(rng):
    d = 12
    base = rng.integers(0, 256, size=(40, d), dtype=np.uint8)
    lib = np.concatenate([base, base, base], axis=0)  # every row tied x3
    pick = rng.integers(0, 40, size=17)
    blocks = base[pick]
    dist, row = distance.l1_argmin(_t(blocks), _t(lib))
    assert (dist.numpy() == 0).all()
    np.testing.assert_array_equal(row.numpy(), pick)
    _, rp = jax_distance._l1_argmin_pallas(blocks, lib, interpret=True)
    np.testing.assert_array_equal(row.numpy(), np.asarray(rp))


def test_l1_argmin_ties_across_chunks(rng, monkeypatch):
    """Ties that straddle the plain version's library chunks fold to the
    lowest row (strict-less fold over ascending chunks)."""
    monkeypatch.setattr(distance, "_chunk_sizes", lambda d: (4, 5))
    lib = np.zeros((23, 3), np.uint8)
    lib[[3, 9, 17]] = 10
    blocks = np.full((6, 3), 10, np.uint8)
    dist, row = distance.l1_argmin(_t(blocks), _t(lib))
    assert (dist.numpy() == 0).all() and (row.numpy() == 3).all()


def test_torch_argmin_returns_first_minimum():
    """l1_argmin_ref relies on it for the lowest-row rule."""
    x = torch.tensor([[3, 1, 1, 0, 0, 5], [7, 7, 7, 7, 7, 7]], dtype=torch.int32)
    assert x.argmin(dim=1).tolist() == [3, 0]
    big = torch.zeros(100000, dtype=torch.int32)
    assert int(big.argmin()) == 0


def test_uint8_subtraction_wraps_so_ref_casts():
    a, b = torch.tensor([1], dtype=torch.uint8), torch.tensor([2], dtype=torch.uint8)
    assert int(a - b) == 255
    dist, _ = distance.l1_argmin(a.reshape(1, 1), b.reshape(1, 1))
    assert int(dist) == 1


def test_k1_wrapper_on_cpu_does_not_launch(rng):
    L1_ARGMIN.launches = 0
    blocks = _t(rng.integers(0, 256, size=(8, 12), dtype=np.uint8))
    lib = _t(rng.integers(0, 256, size=(30, 12), dtype=np.uint8))
    distance.l1_argmin(blocks, lib)
    assert L1_ARGMIN.launches == 0


def test_l1_argmin_checks_its_inputs():
    u8 = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        distance.l1_argmin(u8.to(torch.int32), u8)
    with pytest.raises(ValueError):
        distance.l1_argmin(u8, torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="empty"):
        distance.l1_argmin(u8, torch.zeros((0, 3), dtype=torch.uint8))
