"""Port parity: `emosaic_tpu_torch.ops.lut` against the JAX package.

The whole 256^3 table (16.7M packed (dist, row) keys) must equal JAX's
`build_l1_lut`, exactly, for the same library.
"""

import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as jax_distance
from emosaic_tpu.ops import lut as jax_lut
from emosaic_tpu_torch.ops import distance, lut


def _libs():
    rng = np.random.default_rng(99)
    dup = rng.integers(0, 256, size=(12, 3), dtype=np.uint8)
    return {
        "random": rng.integers(0, 256, size=(41, 3), dtype=np.uint8),
        "extreme": np.array(
            [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]], np.uint8
        ),
        # duplicate colours: the lowest row must own each colour
        "duplicates": np.concatenate([dup, dup[::-1], dup]),
    }


@pytest.mark.parametrize("name", ["random", "extreme", "duplicates"])
def test_lut_equals_jax_everywhere(name, monkeypatch):
    monkeypatch.setenv("EMOSAIC_LUT_CACHE", "0")
    lib = _libs()[name]
    want = np.asarray(jax_lut.build_l1_lut(lib))
    got = lut.build_l1_lut(lib, device="cpu")
    assert got.shape == (256, 256, 256) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_match_equals_plain_argmin(rng):
    lib = rng.integers(0, 256, size=(57, 3), dtype=np.uint8)
    table = lut.build_l1_lut(lib, device="cpu")
    blocks = rng.integers(0, 256, size=(500, 3), dtype=np.uint8)
    blocks[:3] = lib[[0, 7, 56]]
    d, r = lut.lut_match(blocks, table)
    wd, wr = distance.l1_argmin_ref(torch.from_numpy(blocks), torch.from_numpy(lib))
    assert torch.equal(d, wd) and torch.equal(r, wr)
    jd, jr = jax_distance.l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_pack_rgb_host_and_tensor_agree_with_jax(rng):
    blocks = rng.integers(0, 256, size=(64, 3), dtype=np.uint8)
    want = jax_lut.pack_rgb(blocks)
    np.testing.assert_array_equal(lut.pack_rgb(blocks), want)
    np.testing.assert_array_equal(lut.pack_rgb(torch.from_numpy(blocks)).numpy(), want)


def test_lut_cache_hit_miss_and_disable(rng, monkeypatch):
    # the cache is keyed on content, whatever the table: a cheap stand-in
    # build keeps this test off the 16.7M-entry passes
    monkeypatch.setattr(
        lut, "_build", lambda lib, device: torch.from_numpy(lib.astype(np.int32))
    )
    monkeypatch.setattr(lut, "_LUT_CACHE", {})
    monkeypatch.delenv("EMOSAIC_LUT_CACHE", raising=False)
    lib = rng.integers(0, 256, size=(37, 3), dtype=np.uint8)
    a = lut.build_l1_lut(lib, device="cpu")
    assert lut.build_l1_lut(lib.copy(), device="cpu") is a  # same bytes: hit
    assert lut.build_l1_lut(torch.from_numpy(lib), device="cpu") is a
    other = lut.build_l1_lut(lib[:20], device="cpu")  # other content: miss
    assert other is not a
    monkeypatch.setattr(lut, "_LUT_CACHE_MAX", 1)
    lut.build_l1_lut(lib[:10], device="cpu")
    assert len(lut._LUT_CACHE) == 1  # capped: the oldest entry went
    monkeypatch.setattr(lut, "_LUT_CACHE", {})
    monkeypatch.setenv("EMOSAIC_LUT_CACHE", "0")
    c = lut.build_l1_lut(lib, device="cpu")
    assert c is not a and len(lut._LUT_CACHE) == 0
    assert torch.equal(c, a)


def test_lut_rejects_bad_libraries():
    with pytest.raises(ValueError, match="mode-1"):
        lut.build_l1_lut(np.zeros((3, 6), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        lut.build_l1_lut(np.zeros((0, 3), np.uint8), device="cpu")
