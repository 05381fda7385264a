"""The port's native engine (`emosaic_tpu_torch.native`, a copy of the JAX
package's C++ helpers built into `emosaic_tpu_torch/_build/`) and its
device refiller (`ops.distance.DeviceRefiller`) and K12's plain version
(`ops.distance.masked_refill` on CPU tensors) against the JAX package's
pure-Python engines and numpy refill, exactly.

The refiller runs on CPU tensors here (K12's plain version, and the plain
int32 stripes above `_K12_MAX_M` blocks); on the card the same code
launches K12 and K10's stripe.
"""

import numpy as np
import pytest
import torch

from emosaic_tpu.io.prep import trim_bounds as jax_trim_bounds
from emosaic_tpu.render.greedy import (
    greedy_global_assign,
    greedy_sequence_assign,
    make_numpy_refill,
)
from emosaic_tpu_torch import native
from emosaic_tpu_torch.io import prep
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops.distance import I32_MAX, DeviceRefiller, _DeferRefill
from emosaic_tpu_torch.render import greedy as port_greedy


@pytest.fixture
def engine():
    if not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    return native


def _candidates(rng, b, t, d, k):
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    pal = rng.integers(0, 256, size=(t, d), dtype=np.uint8)
    lib = np.concatenate([pal, pal[:, ::-1]])
    dist = np.abs(blocks.astype(np.int32)[:, None, :] - lib.astype(np.int32)[None]).sum(2)
    rows = np.argsort(dist, axis=1, kind="stable")[:, :k].astype(np.int32)
    return blocks, lib, np.take_along_axis(dist, rows, axis=1).astype(np.int32), rows


def _clustered(rng, t, b, d, k):
    centers = rng.integers(0, 256, size=(5, d))
    pal = np.clip(centers[rng.integers(0, 5, t)] + rng.normal(0, 6, (t, d)), 0, 255).astype(np.uint8)
    pal[min(50, t - 1)] = pal[10 % t]  # (dist, row) ties in refills
    lib = np.concatenate([pal, pal[:, ::-1]])
    blocks = np.clip(pal[rng.integers(0, t, b)] + rng.normal(0, 4, (b, d)), 0, 255).astype(np.uint8)
    dist = np.abs(blocks.astype(np.int32)[:, None, :] - lib.astype(np.int32)[None]).sum(2)
    cr = np.argsort(dist, axis=1, kind="stable")[:, :k].astype(np.int32)
    return blocks, lib, np.take_along_axis(dist, cr, axis=1).astype(np.int32), cr


def test_engine_builds_into_the_port_build_dir(engine):
    assert native.library_path().parent.name == "_build"
    assert native.library_path().parent.parent.name == "emosaic_tpu_torch"
    assert native.build() == 0.0  # up to date after the first load


@pytest.mark.parametrize("case", ["random", "exhaustion", "clustered96", "clustered37"])
def test_greedy_global_matches_jax_python_engine(rng, engine, case):
    if case == "random":
        blocks, lib, cd, cr = _candidates(rng, 60, 40, 3, 5)
        t = 40
    elif case == "exhaustion":
        blocks, lib, cd, cr = _candidates(rng, 20, 8, 3, 16)
        t = 8
    else:
        d = int(case[-2:])
        t = 120
        blocks, lib, cd, cr = _clustered(rng, t, 200, d, 6)
    want = greedy_global_assign(cd, cr, 2 * t, t, make_numpy_refill(blocks, lib))
    got = native.greedy_global(cd, cr, blocks, lib, t)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    port_py = port_greedy.greedy_global_assign(
        cd, cr, 2 * t, t, port_greedy.make_numpy_refill(blocks, lib)
    )
    np.testing.assert_array_equal(port_py[0], want[0])


def test_greedy_sequence_matches_jax_python_engine(rng, engine):
    blocks, lib, cd, cr = _candidates(rng, 50, 30, 12, 4)
    order = rng.permutation(50).astype(np.int32)
    want = greedy_sequence_assign(order, cd, cr, 60, make_numpy_refill(blocks, lib))
    got = native.greedy_sequence(order, cd, cr, blocks, lib)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_device_refiller_matches_numpy_refill(rng):
    t, b, d, k = 70, 24, 48, 16
    blocks, lib, _, _ = _clustered(rng, t, b, d, k)
    refill = make_numpy_refill(blocks, lib, k=k)
    dev = DeviceRefiller(blocks, lib, k=k)
    for frac in (0.0, 0.5, 0.95, 1.0):
        used = (rng.random(2 * t) < frac).astype(np.uint8)
        ids = rng.choice(b, size=7, replace=False).astype(np.int64)
        dd, dr = dev(ids, used)
        nd_, nr_ = refill(ids, used.astype(bool))
        for i in range(len(ids)):
            valid = nd_[i] != I32_MAX
            n = int(valid.sum())
            np.testing.assert_array_equal(dd[i][:n], nd_[i][valid])
            np.testing.assert_array_equal(dr[i][:n], nr_[i][valid])
            assert (dd[i][n:] == I32_MAX).all() and (dr[i][n:] == 0).all()


@pytest.mark.parametrize("margin", [0, 64])
def test_greedy_global_device_refill_bit_identical(rng, engine, margin):
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    base = native.greedy_global(cd, cr, blocks, lib, t)
    dev = DeviceRefiller(blocks, lib)
    got = native.greedy_global(
        cd, cr, blocks, lib, t, refill_cb=dev, cb_margin=margin, cb_max_batch=dev.max_batch
    )
    assert dev.n_calls > 0 and dev.n_deferred == 0
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])


def _k12_case(rng, mask, t=517, b=300, d=24, k=16):
    """A library of 2t rows (1034 at t = 517: not a multiple of 4, 32 or
    128), its blocks and candidate lists, and a `used` mask of the named
    kind."""
    blocks, lib, cd, cr = _clustered(rng, t, b, d, 6)
    l = 2 * t
    if mask == "ties":
        # copies of 40 rows (and their mirrors) fill the library: the k-th
        # place falls inside a group of equal distances
        pal = lib[:t].copy()
        pal[40:] = pal[np.arange(40, t) % 40]
        lib = np.concatenate([pal, pal[:, ::-1]])
        blocks[:40] = pal[:40]
        dist = np.abs(blocks.astype(np.int32)[:, None] - lib.astype(np.int32)[None]).sum(2)
        cr = np.argsort(dist, axis=1, kind="stable")[:, :6].astype(np.int32)
        cd = np.take_along_axis(dist, cr, axis=1).astype(np.int32)
    used = np.zeros(l, np.uint8)
    if mask == "all":
        used[:] = 1
    elif mask == "few":  # fewer than k rows left
        used[:] = 1
        used[rng.choice(l, size=k // 2 - 1, replace=False)] = 0
    elif mask in ("ties", "ragged"):
        used[rng.random(l) < 0.5] = 1
    return blocks, lib, cd, cr, used


@pytest.mark.parametrize("m", [1, 3, 64])
@pytest.mark.parametrize("mask", ["none", "all", "few", "ties", "ragged"])
def test_k12_contract_against_numpy_refill_and_host_scan(rng, engine, mask, m):
    """K12's plain version (`masked_refill` on CPU tensors) and the refiller
    against `make_numpy_refill`: the same (distance, row) pairs in order,
    padded with (I32_MAX, 0); calls of at most `_K12_MAX_M` blocks count
    as K12's, larger ones take the stripe. Then the engine with the
    refiller in batches of at most m blocks against its own host scans:
    the same rows and distances."""
    k = 16
    blocks, lib, cd, cr, used = _k12_case(rng, mask, k=k)
    ids = rng.choice(len(blocks), size=m, replace=False).astype(np.int64)
    nd_, nr_ = make_numpy_refill(blocks, lib, k=k)(ids, used.astype(bool))
    kd = distance.masked_refill(torch.from_numpy(blocks), torch.from_numpy(ids),
                                torch.from_numpy(lib), torch.from_numpy(used), k).numpy()
    dev = DeviceRefiller(blocks, lib, k=k)
    dd, dr = dev(ids, used)
    for got_d, got_r in ((kd[0], kd[1]), (dd, dr)):
        for i in range(m):
            valid = nd_[i] != I32_MAX
            n = int(valid.sum())
            assert n == min(k, int((used == 0).sum()))
            np.testing.assert_array_equal(got_d[i][:n], nd_[i][valid])
            np.testing.assert_array_equal(got_r[i][:n], nr_[i][valid])
            assert (got_d[i][n:] == I32_MAX).all() and (got_r[i][n:] == 0).all()
    if mask == "ties":  # the k-th place cuts a group of equal distances
        assert any(dd[i][k - 1] == dd[i][k - 2] for i in range(m))
    if mask != "all":  # an all-used mask is answered on the host
        assert dev.n_calls == 1 and dev.n_blocks == m and dev.n_rows == int((used == 0).sum())
        assert dev.n_fused == int(m <= distance._K12_MAX_M)
    t = len(lib) // 2
    base = native.greedy_global(cd, cr, blocks, lib, t)
    dev = DeviceRefiller(blocks, lib)
    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev, cb_max_batch=m)
    assert dev.n_calls > 0 and dev.n_deferred == 0
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])


def test_device_refiller_serves_the_first_event_on_the_device(rng, engine):
    """No event waits on the host scan: a fresh refiller's first call is a
    K12 call, and an engine run with it makes no host scan."""
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    dev = DeviceRefiller(blocks, lib)
    dd, _ = dev(np.arange(3, dtype=np.int64), np.zeros(2 * t, np.uint8))
    assert (dd[:, 0] < I32_MAX).all()
    assert (dev.n_calls, dev.n_fused, dev.n_deferred) == (1, 1, 0)
    stats = {}
    dev = DeviceRefiller(blocks, lib)
    native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev,
                         cb_max_batch=distance._K12_MAX_M, stats=stats)
    assert stats["refill_host_events"] == 0 and dev.n_fused == dev.n_calls > 0
    with pytest.raises(ValueError, match="k must be"):
        DeviceRefiller(blocks, lib, k=distance._K12_MAX_K + 1)


def test_refill_callback_failure_raises_and_deferrals_stay_silent(rng, engine, capfd, monkeypatch):
    """A deferral falls back to the host scan silently; any other callback
    exception stops the engine and is raised, not served by host scans."""
    blocks, lib, cd, cr = _candidates(rng, 60, 30, 12, 3)
    base = native.greedy_global(cd, cr, blocks, lib, 30)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes - 1)
    dev = DeviceRefiller(blocks, lib)  # oversized: always defers
    got = native.greedy_global(cd, cr, blocks, lib, 30, refill_cb=dev)
    np.testing.assert_array_equal(got[0], base[0])
    assert dev.n_deferred > 0 and dev.n_calls == 0
    assert "refill" not in capfd.readouterr().err
    calls = []

    def broken(ids, used):
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        native.greedy_global(cd, cr, blocks, lib, 30, refill_cb=broken)
    assert len(calls) == 1  # the engine stopped at the first failure


def test_exhaustion_short_circuit_never_reaches_the_callback(rng, engine):
    t, b, d, k = 30, 90, 24, 3
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    seen = []

    def spy(ids, used):
        seen.append(int((used == 0).sum()))
        raise _DeferRefill(0)

    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=spy)
    assert int((got[0] >= 0).sum()) == t and all(n > 0 for n in seen)
    want = greedy_global_assign(cd, cr, 2 * t, t, make_numpy_refill(blocks, lib))
    np.testing.assert_array_equal(got[0], want[0])


def test_device_refiller_oversized_library_stays_on_host(rng, engine, monkeypatch):
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    base = native.greedy_global(cd, cr, blocks, lib, t)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes - 1)
    dev = DeviceRefiller(blocks, lib)
    assert dev.oversized
    with pytest.raises(_DeferRefill):
        dev(np.arange(3, dtype=np.int64), np.zeros(2 * t, np.uint8))
    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev, cb_max_batch=dev.max_batch)
    assert dev.n_calls == 0 and dev.n_deferred > 1
    np.testing.assert_array_equal(got[0], base[0])


def test_cb_k_follows_the_refiller(rng, engine):
    blocks, lib, cd, cr = _candidates(rng, 70, 40, 12, 4)
    base = native.greedy_global(cd, cr, blocks, lib, 40)
    dev = DeviceRefiller(blocks, lib, k=16)
    got = native.greedy_global(cd, cr, blocks, lib, 40, refill_cb=dev, cb_max_batch=dev.max_batch)
    assert dev.n_calls > 0
    np.testing.assert_array_equal(got[0], base[0])


@pytest.mark.parametrize("refiller", [None, "device", "deferring"])
def test_greedy_global_stats_leave_the_rows_alone(rng, engine, refiller, monkeypatch):
    """`stats` gets the engine's host scans and their seconds; the rows and
    distances are the ones without it. A deferring refiller is one whose
    library is past the device budget."""
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    base = native.greedy_global(cd, cr, blocks, lib, t)
    kw = {}
    if refiller is not None:
        if refiller == "deferring":
            monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes - 1)
        dev = DeviceRefiller(blocks, lib)
        kw = dict(refill_cb=dev, cb_max_batch=dev.max_batch)
    stats = {}
    got = native.greedy_global(cd, cr, blocks, lib, t, stats=stats, **kw)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])
    assert set(stats) == {"refill_host_events", "refill_host_s", "engine_entries"}
    assert stats["engine_entries"] >= np.count_nonzero(got[0] >= 0)
    if refiller == "device":
        assert stats["refill_host_events"] == 0 and stats["refill_host_s"] == 0.0
        assert dev.n_calls > 0
    else:
        assert stats["refill_host_events"] > 0 and stats["refill_host_s"] > 0
    if refiller == "deferring":
        assert stats["refill_host_events"] == dev.n_deferred


def test_native_trim_matches_numpy_trim(rng, engine):
    img = np.full((30, 44, 3), 255, dtype=np.uint8)
    img[5:25, 8:40] = rng.integers(0, 200, size=(20, 32, 3), dtype=np.uint8)
    img[7, :] = 255
    assert native.trim_bounds(img) == prep.trim_bounds(img) == jax_trim_bounds(img)
    for _ in range(5):
        h, w = rng.integers(8, 40, size=2)
        im = np.where(rng.random((h, w, 1)) < 0.3, 255, rng.integers(0, 256, (h, w, 3))).astype(np.uint8)
        try:
            want = prep.trim_bounds(im)
        except ValueError:
            with pytest.raises(ValueError):
                native.trim_bounds(im)
            continue
        assert native.trim_bounds(im) == want
    with pytest.raises(ValueError):
        native.trim_bounds(np.full((8, 8, 3), 255, dtype=np.uint8))
    with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
        native.trim_bounds(rng.integers(0, 200, size=(8, 8), dtype=np.uint8))


def test_prep_uses_the_native_trim(rng, engine, monkeypatch):
    from PIL import Image

    calls = []
    real = native.trim_bounds
    monkeypatch.setattr(native, "trim_bounds", lambda a: calls.append(1) or real(a))
    img = np.full((40, 50, 3), 255, dtype=np.uint8)
    img[4:36, 6:44] = rng.integers(0, 200, size=(32, 38, 3), dtype=np.uint8)
    cropped, mindim = prep._trim_crop(Image.fromarray(img), False)
    assert calls and cropped.size == (37, 31) and mindim == 31
