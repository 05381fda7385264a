"""The port's native engine (`emosaic_tpu_torch.native`, a copy of the JAX
package's C++ helpers built into `emosaic_tpu_torch/_build/`) and its
device refiller (`ops.refill.DeviceRefiller`, and `refiller_for`, the rule
that picks it) and K12's plain version (`ops.refill.masked_refill` on CPU
tensors) against the JAX package's pure-Python engines and numpy refill,
exactly.

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
from emosaic_tpu_torch.ops import distance, refill
from emosaic_tpu_torch.ops.distance import I32_MAX
from emosaic_tpu_torch.ops.refill import DeviceRefiller, refiller_for
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


#: (tiles T, blocks, bytes a row, library rows past the 2T of the tiles and
#: their mirrors): the engine on the u32 keys against the engine on the pair
#: they decode to. "full": B = T, every tile used, lists read to their end;
#: "ties": bytes of three levels, so many rows share a distance; "pow2": L =
#: 2^7, every column bit of the last row set; "pow2+1": L = 2^7 + 1, one
#: column bit more
KEY_CASES = {"random": (40, 60, 12, 0), "full": (64, 64, 12, 0), "ties": (50, 50, 3, 0),
             "pow2": (64, 40, 12, 0), "pow2+1": (64, 40, 12, 1)}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_greedy_global_on_keys_matches_the_pair(rng, engine, case):
    """The engine on `sorted_lists`' u32 keys (made by K13's plain version
    on CPU tensors) against the engine on the (distance, row) pair they
    decode to: the same rows, distances and stats, mirror pairs excluded.
    Keys take neither a row array nor a refill callback."""
    t, b, d, extra = KEY_CASES[case]
    levels = (lambda size: rng.integers(0, 3, size=size) * 127) if case == "ties" else (
        lambda size: rng.integers(0, 256, size=size))
    pal = levels((t, d)).astype(np.uint8)
    lib = np.concatenate([pal, pal[:, ::-1], levels((extra, d)).astype(np.uint8)])
    blocks = levels((b, d)).astype(np.uint8)
    dist = np.abs(blocks.astype(np.int32)[:, None] - lib.astype(np.int32)[None]).sum(2)
    keys, bits_c = distance.sorted_lists(torch.from_numpy(dist.astype(np.int32)), 255 * d)
    assert keys.dtype == np.uint32 and bits_c == (len(lib) - 1).bit_length()
    assert bits_c == {"pow2": 7, "pow2+1": 8}.get(case, bits_c)
    cd, cr = distance.unpack_lists(keys, bits_c)
    want_stats, got_stats = {}, {}
    want = native.greedy_global(cd, cr, blocks, lib, t, stats=want_stats)
    got = native.greedy_global(keys, None, blocks, lib, t, bits_c=bits_c, stats=got_stats)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for key in ("refill_host_events", "engine_entries"):
        assert got_stats[key] == want_stats[key]
    assert got_stats["refill_host_events"] == 0  # full lists never run dry
    rows = got[0][got[0] >= 0]
    assert len(rows) == min(b, t)
    tiles = np.where(rows < 2 * t, rows % t, rows)
    assert len(set(tiles.tolist())) == len(rows)  # each tile once, in one orientation
    if case == "ties":
        assert len(np.unique(dist)) <= 2 * d + 1
    with pytest.raises(ValueError, match="packed keys"):
        native.greedy_global(keys, cr, blocks, lib, t, bits_c=bits_c)
    with pytest.raises(ValueError, match="packed keys"):
        native.greedy_global(keys, None, blocks, lib, t, bits_c=bits_c,
                             refill_cb=DeviceRefiller(blocks, lib))


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
    host = make_numpy_refill(blocks, lib, k=k)
    dev = DeviceRefiller(blocks, lib, k=k)
    for frac in (0.0, 0.5, 0.95, 1.0):
        used = (rng.random(2 * t) < frac).astype(np.uint8)
        ids = rng.choice(b, size=7, replace=False).astype(np.int64)
        dd, dr = dev(ids, used)
        nd_, nr_ = host(ids, used.astype(bool))
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
    assert dev.n_calls > 0
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
    kd = refill.masked_refill(torch.from_numpy(blocks), torch.from_numpy(ids),
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
        assert dev.n_fused == int(m <= refill._K12_MAX_M)
    t = len(lib) // 2
    base = native.greedy_global(cd, cr, blocks, lib, t)
    dev = DeviceRefiller(blocks, lib)
    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev, cb_max_batch=m)
    assert dev.n_calls > 0
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
    assert (dev.n_calls, dev.n_fused) == (1, 1)
    stats = {}
    dev = DeviceRefiller(blocks, lib)
    native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev,
                         cb_max_batch=refill._K12_MAX_M, stats=stats)
    assert stats["refill_host_events"] == 0 and dev.n_fused == dev.n_calls > 0
    with pytest.raises(ValueError, match="k must be"):
        DeviceRefiller(blocks, lib, k=refill._K12_MAX_K + 1)


@pytest.mark.parametrize("case", ["below", "past_budget", "device"])
def test_refiller_for_is_the_one_rule(rng, monkeypatch, case):
    """`refiller_for` leaves a render on the engine's host scan (None)
    where L * D is under `_DEVICE_REFILL_MIN_LD` or the library is past
    `DEVICE_LIB_BYTES_MAX`, both read at call time; at the threshold and
    at the budget it gives a `DeviceRefiller` on the blocks' device."""
    blocks, lib, _, _ = _clustered(rng, 70, 24, 48, 4)
    monkeypatch.setattr(refill, "_DEVICE_REFILL_MIN_LD", lib.size + (case == "below"))
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.size - (case == "past_budget"))
    got = refiller_for(torch.from_numpy(blocks), torch.from_numpy(lib))
    if case == "device":
        assert isinstance(got, DeviceRefiller) and got.device.type == "cpu"
        assert (got.l, got.n_calls) == (len(lib), 0)
    else:
        assert got is None


def test_refill_callback_failure_raises_and_deferrals_stay_silent(rng, engine, capfd, monkeypatch):
    """A library past the device budget gets no callback (`refiller_for`
    gives None) and the engine's host scans serve it silently; a callback
    exception stops the engine and is raised, not served by host scans."""
    blocks, lib, cd, cr = _candidates(rng, 60, 30, 12, 3)
    base = native.greedy_global(cd, cr, blocks, lib, 30)
    monkeypatch.setattr(refill, "_DEVICE_REFILL_MIN_LD", 0)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes - 1)
    assert refiller_for(blocks, lib) is None
    stats = {}
    got = native.greedy_global(cd, cr, blocks, lib, 30, refill_cb=refiller_for(blocks, lib),
                               stats=stats)
    np.testing.assert_array_equal(got[0], base[0])
    assert stats["refill_host_events"] > 0
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
    host = make_numpy_refill(blocks, lib, k=16)

    def spy(ids, used):
        seen.append(int((used == 0).sum()))
        return host(ids, used.astype(bool))

    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=spy, cb_k=16)
    assert int((got[0] >= 0).sum()) == t and seen and all(n > 0 for n in seen)
    want = greedy_global_assign(cd, cr, 2 * t, t, make_numpy_refill(blocks, lib))
    np.testing.assert_array_equal(got[0], want[0])


def test_device_refiller_oversized_library_stays_on_host(rng, engine, monkeypatch):
    """The refiller refuses a library past `DEVICE_LIB_BYTES_MAX` (read at
    call time) and takes one at the budget."""
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes - 1)
    with pytest.raises(ValueError, match="device budget"):
        DeviceRefiller(blocks, lib)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", lib.nbytes)
    dev = DeviceRefiller(blocks, lib)
    base = native.greedy_global(cd, cr, blocks, lib, t)
    got = native.greedy_global(cd, cr, blocks, lib, t, refill_cb=dev, cb_max_batch=dev.max_batch)
    assert dev.n_calls > 0
    np.testing.assert_array_equal(got[0], base[0])


def test_cb_k_follows_the_refiller(rng, engine):
    blocks, lib, cd, cr = _candidates(rng, 70, 40, 12, 4)
    base = native.greedy_global(cd, cr, blocks, lib, 40)
    dev = DeviceRefiller(blocks, lib, k=16)
    got = native.greedy_global(cd, cr, blocks, lib, 40, refill_cb=dev, cb_max_batch=dev.max_batch)
    assert dev.n_calls > 0
    np.testing.assert_array_equal(got[0], base[0])


@pytest.mark.parametrize("refiller", [None, "device", "host"])
def test_greedy_global_stats_leave_the_rows_alone(rng, engine, refiller):
    """`stats` gets the engine's host scans and their seconds; the rows and
    distances are the ones without it. The "host" callback serves every
    event with the JAX package's numpy refill, so the engine scans none."""
    t, b, d, k = 120, 200, 96, 6
    blocks, lib, cd, cr = _clustered(rng, t, b, d, k)
    base = native.greedy_global(cd, cr, blocks, lib, t)
    kw = {}
    calls = []
    if refiller == "device":
        dev = DeviceRefiller(blocks, lib)
        kw = dict(refill_cb=dev, cb_max_batch=dev.max_batch)
    elif refiller == "host":
        host = make_numpy_refill(blocks, lib, k=16)
        kw = dict(refill_cb=lambda ids, used: calls.append(1) or host(ids, used.astype(bool)),
                  cb_k=16)
    stats = {}
    got = native.greedy_global(cd, cr, blocks, lib, t, stats=stats, **kw)
    np.testing.assert_array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[1], base[1])
    assert set(stats) == set(native.STATS)
    assert {"refill_host_events", "refill_host_s", "engine_entries"} <= set(stats)
    assert stats["engine_entries"] >= np.count_nonzero(got[0] >= 0)
    if refiller is None:
        assert stats["refill_host_events"] > 0 and stats["refill_host_s"] > 0
    else:
        assert stats["refill_host_events"] == 0 and stats["refill_host_s"] == 0.0
        assert (dev.n_calls if refiller == "device" else len(calls)) > 0


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
