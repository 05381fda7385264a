"""Port parity: `emosaic_tpu_torch.parallel` against `emosaic_tpu.parallel`.

Case for case with `tests/test_sharding.py`, in one process on the CPU:
the same numpy inputs go through the JAX package's sharded functions (on
conftest's 8 virtual CPU devices) and its single-device oracles, and
through the port's sharded functions on a virtual mesh of 8 positions on
the one CPU device (`make_mesh(..., devices=[cpu] * 8)`). Equality is
exact (tolerance 0): distances, rows, lattice keys and mosaic bytes.

Not mirrored: JAX's jit-cache test (the port runs eagerly) and its i32
stripe form (`_stripe_f32_ok`, not ported). JAX's DMA-banked library
(`_DMA_LIB_BYTES_MAX`, not ported: K3 takes 64-bit offsets) is held
against the port's unbanked scorer.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from emosaic_tpu import cli as jax_cli
from emosaic_tpu import parallel as jpar
from emosaic_tpu.ops import distance as jdd
from emosaic_tpu.ops.analysis import analyse_batch, source_blocks
from emosaic_tpu.ops.composite import compose_mosaic
from emosaic_tpu.ops.lut import build_l1_lut
from emosaic_tpu_torch import cli
from emosaic_tpu_torch import parallel as tpar
from emosaic_tpu_torch.ops import distance as tdd
from emosaic_tpu_torch.parallel import sharded as tsh

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def _meshes(n, model=1):
    return jpar.make_mesh(n, model=model), tpar.make_mesh(n, model=model, devices=CPU8[:n])


def _eq(*pairs):
    for got, want in pairs:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _clustered(rng, b, d=48, l=9000):
    """The adaptive scorer's test data of tests/test_sharding.py: 50 base
    rows, each repeated with +-5 noise, and blocks near library rows."""
    bases = rng.integers(0, 256, size=(50, d))
    lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)), 0, 255
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=b)].astype(np.int32) + rng.integers(-3, 4, size=(b, d)),
        0, 255,
    ).astype(np.uint8)
    return blocks, lib


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_match_bit_identical(rng, devices, data, model):
    jm, tm = _meshes(8, model)
    pal = rng.integers(0, 256, size=(97, 4, 3), dtype=np.uint8)
    lib = np.array(jdd.build_library(pal))  # 194 rows, not divisible: pads
    blocks = rng.integers(0, 256, size=(131, 12), dtype=np.uint8)
    lib[50] = lib[3]  # a cross-shard tie
    blocks[7] = lib[3]
    want = jdd.l1_argmin_xla(blocks, lib)
    got = tpar.sharded_l1_argmin(blocks, lib, tm)
    _eq(*zip(got, want), *zip(got, jpar.sharded_l1_argmin(blocks, lib, jm)))
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


@pytest.mark.parametrize("model,dim,t,shape", [(2, 2, 32, (16, 12, 3)), (4, 1, 16, (4, 6, 3))])
def test_sharded_mosaic_step_matches_single_chip(rng, devices, model, dim, t, shape):
    jm, tm = _meshes(8, model)
    ts = 4
    tiles = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=shape, dtype=np.uint8)
    got = tpar.sharded_mosaic_step(tiles, src, tm, dim, ts)
    pal = np.asarray(analyse_batch(tiles, dim))
    lib = np.asarray(jdd.build_library(pal))
    _, rows = jdd.l1_argmin_xla(np.asarray(source_blocks(src, dim)), lib)
    items = np.asarray(jdd.rows_to_items(rows, t)).reshape(shape[0] // dim, shape[1] // dim)
    want = np.asarray(compose_mosaic(items, tiles))
    assert got.shape == want.shape == (shape[0] // dim * ts, shape[1] // dim * ts, 3)
    _eq((got, want), (got, jpar.sharded_mosaic_step(tiles, src, jm, dim, ts)))


@pytest.mark.parametrize("n", [8, 4])
def test_ring_rotation_matcher_bit_identical(rng, devices, n):
    jm, tm = _meshes(n)
    pal = rng.integers(0, 256, size=(53, 1, 3), dtype=np.uint8)
    lib = np.array(jdd.build_library(pal))
    blocks = rng.integers(0, 256, size=(77, 3), dtype=np.uint8)
    lib[30] = lib[2]  # a cross-shard tie
    blocks[5] = lib[2]
    want = jdd.l1_argmin_xla(blocks, lib)
    got = tpar.sharded_l1_argmin_ring(blocks, lib, tm)
    _eq(*zip(got, want), *zip(got, jpar.sharded_l1_argmin_ring(blocks, lib, jm)))


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (1, 8)])
def test_sharded_topk_bit_identical(rng, devices, data, model):
    jm, tm = _meshes(8, model)
    pal = rng.integers(0, 256, size=(45, 4, 3), dtype=np.uint8)
    lib = np.array(jdd.build_library(pal))  # 90 rows -> padded per shard
    lib[60] = lib[2]  # a cross-shard tie
    blocks = rng.integers(0, 256, size=(53, 12), dtype=np.uint8)
    blocks[11] = lib[2]
    for ll, k in ((lib, 7), (lib[:5], 9)):  # and k > L: I32_MAX / row-0 padding
        want = jdd.l1_topk_stripes(blocks, ll, k)
        got = tpar.sharded_l1_topk(blocks, ll, k, tm)
        _eq(*zip(got, want), *zip(got, jpar.sharded_l1_topk(blocks, ll, k, jm)))
        assert got[0].shape == (53, k)


def test_shard_cap_rule():
    # P4's shards: k = 512 against 32767 rows, four nearest a segment: 16
    assert tsh._shard_cap(512, 32767) == 16
    assert tsh._shard_cap(256, 32768) == tdd._TL_CAP  # exactly one a segment
    assert tsh._shard_cap(7, 45) == 16


@pytest.mark.parametrize("n,model", [(4, 2), (8, 2)])
@pytest.mark.parametrize("l", [1999, 2000])
def test_sharded_topk_two_level_with_fallback_bit_identical(rng, devices, monkeypatch, n, model,
                                                            l):
    """Shards large enough for the two-level selection (K10's fused entry
    on the card, `_l1_topcap_ref` here): a run of near-equal rows inside
    one shard's segment makes its blocks fail the certificate, so the
    dense stripe recomputes those rows alone; blocks of uniform noise
    certify. With L = 1999 the last shard ends in a padding row (col >=
    real_l). 2x2 and 4x2 meshes against the JAX package's route and the
    stripes."""
    jm, tm = _meshes(n, model)
    d, k = 12, 20
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    base = rng.integers(0, 256, size=d)
    lib[1100:1140] = np.clip(base + rng.integers(-2, 3, (40, d)), 0, 255)  # shard 1, one segment
    lib[1800] = lib[5]  # a tie across the two library shards
    blocks = rng.integers(0, 256, size=(45, d), dtype=np.uint8)
    blocks[:20] = np.clip(base + rng.integers(-2, 3, (20, d)), 0, 255)
    blocks[30] = lib[5]
    dense, two = [], []
    real_dense, real_two = tsh._local_dense, tdd._twolevel_keys
    monkeypatch.setattr(tsh, "_local_dense",
                        lambda x, *a: dense.append(x.shape[0]) or real_dense(x, *a))
    monkeypatch.setattr(tdd, "_twolevel_keys",
                        lambda x, *a: two.append(x.shape[0]) or real_two(x, *a))
    got = tpar.sharded_l1_topk(blocks, lib, k, tm)
    assert len(two) == n and 0 < sum(dense) < sum(two)  # every shard two-level, some rows fall back
    _eq(*zip(got, jdd.l1_topk_stripes(blocks, lib, k)),
        *zip(got, jpar.sharded_l1_topk(blocks, lib, k, jm)))


def test_sharded_topk_large_k_keeps_the_dense_stripe(rng, devices, monkeypatch):
    """k above a shard's valid rows or its survivors: the shard takes the
    dense stripe, as before."""
    jm, tm = _meshes(8, 2)
    lib = rng.integers(0, 256, size=(300, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    two = []
    real_two = tdd._twolevel_keys
    monkeypatch.setattr(tdd, "_twolevel_keys",
                        lambda x, *a: two.append(1) or real_two(x, *a))
    got = tpar.sharded_l1_topk(blocks, lib, 151, tm)
    assert not two
    _eq(*zip(got, jdd.l1_topk_stripes(blocks, lib, 151)),
        *zip(got, jpar.sharded_l1_topk(blocks, lib, 151, jm)))


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_sharded_lut_build_bit_identical(rng, devices, n):
    jm, tm = _meshes(n)
    lib = rng.integers(0, 256, size=(300, 3), dtype=np.uint8)
    lib[250] = lib[7]  # duplicate colours: the lowest row must win
    lib[299] = lib[0]
    want = np.asarray(jax.device_get(build_l1_lut(lib)))
    got = tpar.sharded_build_l1_lut(lib, tm)
    assert got.dtype == np.int32 and got.shape == (256, 256, 256)
    _eq((got, want), (got, jpar.sharded_build_l1_lut(lib, jm)))


@pytest.mark.parametrize("data,model,b", [(8, 1, 520), (4, 2, 37), (2, 4, 1024)])
def test_sharded_adaptive_topk_bit_identical(rng, devices, data, model, b):
    """Must take the adaptive route (a silent reroute would test nothing:
    the JAX test's own note) and equal the JAX scorers and the stripes."""
    jm, tm = _meshes(8, model)
    blocks, lib = _clustered(rng, b)
    blocks[5] = lib[7]  # an exact hit, and duplicate-row ties
    lib[100] = lib[7]
    k = 4
    st = {}
    got = tpar.sharded_l1_topk_adaptive(blocks, lib, k, tm, stats=st)
    assert st["route"] == "adaptive" and st["shards"] == 8, st
    assert st["certified"] + st["fallback"] == b
    want = jdd.l1_topk_stripes(blocks, lib, k)
    _eq(*zip(got, want), *zip(got, jpar.sharded_l1_topk_adaptive(blocks, lib, k, jm)),
        *zip(got, jdd.l1_topk_adaptive(blocks, lib, k)))


def test_sharded_adaptive_topk_banked_library(rng, devices, monkeypatch):
    """JAX's replicated library split into DMA banks (its limit forced
    small) against the port's one library (K3 takes 64-bit offsets)."""
    jm, tm = _meshes(8, 2)
    d, k = 48, 4
    monkeypatch.setattr(jdd, "_DMA_LIB_BYTES_MAX", 4096 * d)
    assert len(jdd._lib_banks(np.zeros((9088, d), np.uint8), d)) == 3
    blocks, lib = _clustered(rng, 64)
    st = {}
    got = tpar.sharded_l1_topk_adaptive(blocks, lib, k, tm, stats=st)
    assert st["route"] == "adaptive", st
    _eq(*zip(got, jpar.sharded_l1_topk_adaptive(blocks, lib, k, jm)),
        *zip(got, jdd.l1_topk_stripes(blocks, lib, k)))


def test_sharded_adaptive_topk_concentrated_reroutes(rng, devices, monkeypatch):
    """Uniform data: the sample gate (not eligibility: the library is
    adaptive-eligible) must reroute to the sharded stripes."""
    jm, tm = _meshes(8, 2)
    d, l, k = 48, 9000, 4
    rerouted = []
    real = tsh.sharded_l1_topk

    def spy(*a, **kw):
        rerouted.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(tsh, "sharded_l1_topk", spy)
    blocks = rng.integers(0, 256, size=(19, d), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    st = {}
    got = tsh.sharded_l1_topk_adaptive(blocks, lib, k, tm, stats=st)
    assert rerouted and st["route"] == "stripes (sample gate)", st
    _eq(*zip(got, jdd.l1_topk_stripes(blocks, lib, k)),
        *zip(got, jpar.sharded_l1_topk_adaptive(blocks, lib, k, jm)))


def test_sharded_adaptive_topk_multi_slice(rng, devices, monkeypatch):
    """Several block slices (128 + 128 + 64 rows) through both packages."""
    monkeypatch.setattr(jdd, "_AD_B_SLICE", 16)  # a slice = 16 * 8 = 128 rows
    monkeypatch.setattr(tdd, "_AD_B_SLICE", 16)
    jm, tm = _meshes(8)
    blocks, lib = _clustered(rng, 300)  # bc = 8, unit = 64 -> bp = 320
    calls = []
    real = tdd._run_block_slices

    def spy(x, b_slice, kk, run):
        calls.append(b_slice)
        return real(x, b_slice, kk, run)

    monkeypatch.setattr(tdd, "_run_block_slices", spy)
    st = {}
    got = tpar.sharded_l1_topk_adaptive(blocks, lib, 4, tm, stats=st)
    assert st["route"] == "adaptive" and calls == [128], (st, calls)
    _eq(*zip(got, jdd.l1_topk_stripes(blocks, lib, 4)),
        *zip(got, jpar.sharded_l1_topk_adaptive(blocks, lib, 4, jm)))


def test_sharded_adaptive_oversized_library_streams(rng, devices, monkeypatch):
    """Past the device budget both stream host banks, each scored by the
    sharded scorer itself (4096 + 4096 + 808 rows; no re-entry)."""
    jm, tm = _meshes(8)
    d, k = 48, 4
    blocks, lib = _clustered(rng, 64)
    blocks[5] = lib[7]
    lib[100] = lib[7]
    want = jdd.l1_topk_stripes(blocks, lib, k)
    monkeypatch.setattr(jdd, "_DEVICE_LIB_BYTES_MAX", 4096 * d)
    monkeypatch.setattr(tdd, "DEVICE_LIB_BYTES_MAX", 4096 * d)
    st = {}
    got = tpar.sharded_l1_topk_adaptive(blocks, lib, k, tm, stats=st)
    assert st["route"] == "streamed", st
    _eq(*zip(got, want), *zip(got, jpar.sharded_l1_topk_adaptive(blocks, lib, k, jm)))


def test_sharded_argmin_topk_oversized_per_shard_streams(rng, devices, monkeypatch):
    """The three library-sharding routes stream host banks through
    themselves when a "model" shard exceeds the budget, ties included."""
    jm, tm = _meshes(8, 2)
    l, d, k = 2000, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(40, d)) * 16).astype(np.uint8)
    wa, wt = jdd.l1_argmin_xla(blocks, lib), jdd.l1_topk_stripes(blocks, lib, k)
    monkeypatch.setattr(jdd, "_DEVICE_LIB_BYTES_MAX", 256 * d)
    monkeypatch.setattr(tdd, "DEVICE_LIB_BYTES_MAX", 256 * d)
    for name, want in (("sharded_l1_argmin", wa), ("sharded_l1_argmin_ring", wa)):
        got = getattr(tpar, name)(blocks, lib, tm)
        _eq(*zip(got, want), *zip(got, getattr(jpar, name)(blocks, lib, jm)))
    got = tpar.sharded_l1_topk(blocks, lib, k, tm)
    _eq(*zip(got, wt), *zip(got, jpar.sharded_l1_topk(blocks, lib, k, jm)))


def test_sharded_prepared_library_bit_identical(rng, devices):
    """A pre-padded library handle gives the internal upload's results on
    every library-sharding route; a handle for another library is
    refused with the JAX package's message."""
    _, tm = _meshes(8, 2)
    l, d, k = 500, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(24, d)) * 16).astype(np.uint8)
    prep2, prep8 = tsh._pad_prepare(2)(lib, d), tsh._pad_prepare(8)(lib, d)
    _eq(*zip(tpar.sharded_l1_topk(blocks, lib, k, tm, prepared=prep2),
             jdd.l1_topk_stripes(blocks, lib, k)))
    want = jdd.l1_argmin_xla(blocks, lib)
    _eq(*zip(tpar.sharded_l1_argmin(blocks, lib, tm, prepared=prep2), want))
    _eq(*zip(tpar.sharded_l1_argmin_ring(blocks, lib, tm, prepared=prep8), want))
    with pytest.raises(ValueError, match="prepared library"):
        jpar.sharded_l1_topk(blocks, lib[: l - 100], k, jpar.make_mesh(8, model=2),
                             prepared=jpar.sharded._pad_prepare(2)(lib, d))
    with pytest.raises(ValueError, match="prepared library"):
        tpar.sharded_l1_topk(blocks, lib[: l - 100], k, tm, prepared=prep2)


def test_sharded_adaptive_prepared_banks_bit_identical(rng, devices):
    """The sharded adaptive scorer takes the single-device scorer's
    `_ad_prepare` handle, and refuses a mismatched one."""
    _, tm = _meshes(8)
    d, l, k = 48, 9000, 4
    blocks, lib = _clustered(rng, 64)
    handle = tdd._ad_prepare(lib, d)
    st = {}
    got = tpar.sharded_l1_topk_adaptive(blocks, lib, k, tm, prepared=handle, stats=st)
    assert st["route"] == "adaptive"
    _eq(*zip(got, tpar.sharded_l1_topk_adaptive(blocks, lib, k, tm)),
        *zip(got, jdd.l1_topk_stripes(blocks, lib, k)))
    with pytest.raises(ValueError, match="prepared banks"):
        tpar.sharded_l1_topk_adaptive(blocks, lib[: l - 500], k, tm, prepared=handle)


def test_sharded_streamed_prefetch_delivers_handles(rng, devices, monkeypatch):
    """The oversized-library gates' bank scorers expose `prepare`, so the
    streamer's worker thread pads and uploads every bank ahead."""
    _, tm = _meshes(8, 2)
    l, d, k = 2000, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(40, d)) * 16).astype(np.uint8)
    want = jdd.l1_topk_stripes(blocks, lib, k)
    rows = []
    real = tsh._pad_prepare

    def spy(mult, device=None):
        inner = real(mult, device)

        def wrapped(ll, *a, **kw):
            rows.append(ll.shape[0])
            return inner(ll, *a, **kw)

        return wrapped

    monkeypatch.setattr(tsh, "_pad_prepare", spy)
    monkeypatch.setattr(tdd, "DEVICE_LIB_BYTES_MAX", 256 * d)
    got = tpar.sharded_l1_topk(blocks, lib, k, tm)
    assert rows and sum(rows) == l  # every bank prefetched
    _eq(*zip(got, want))


def test_sharded_validation_errors(rng):
    """Both packages refuse the same shapes with the same messages."""
    tiles = rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    tiles4 = rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8)
    src_odd = rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8)
    for par, kw in ((jpar, {}), (tpar, {"devices": CPU8})):
        with pytest.raises(ValueError, match="not divisible by model"):
            par.make_mesh(8, model=3, **kw)
        mesh6 = par.make_mesh(6, model=1, **kw)  # 256 % 6 != 0
        with pytest.raises(ValueError, match="not divisible by 6 devices"):
            par.sharded_build_l1_lut(np.zeros((4, 3), np.uint8), mesh6)
        mesh8 = par.make_mesh(8, model=2, **kw)
        with pytest.raises(ValueError, match=r"requires \[L,3\]"):
            par.sharded_build_l1_lut(np.zeros((4, 6), np.uint8), mesh8)
        with pytest.raises(ValueError, match="out of range"):
            par.sharded_build_l1_lut(np.zeros((0, 3), np.uint8), mesh8)
        with pytest.raises(ValueError, match="not divisible by model"):
            par.sharded_mosaic_step(tiles, src, mesh8, 2, 8)  # T=3, model=2
        with pytest.raises(ValueError, match="block rows"):
            par.sharded_mosaic_step(tiles4, src_odd, mesh8, 2, 8)  # nby=3, data=4


def test_ring_argmin_streams_beyond_budget(rng, monkeypatch):
    _, tm = _meshes(8)
    blocks = rng.integers(0, 256, size=(16, 3), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(600, 3), dtype=np.uint8)
    want = jdd.l1_argmin_xla(blocks, lib)
    monkeypatch.setattr(tdd, "DEVICE_LIB_BYTES_MAX", 16)
    _eq(*zip(tpar.sharded_l1_argmin_ring(blocks, lib, tm), want))


def test_make_mesh_without_a_gpu_raises(monkeypatch):
    """The default devices are the GPUs: with none visible make_mesh
    raises, it never takes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        tpar.make_mesh()
    mesh = tpar.make_mesh(4, model=2, devices=CPU8[:4])
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.axis_names == ("data", "model") and mesh.local_positions() == [0, 1, 2, 3]


def test_parse_mesh_specs(monkeypatch):
    """JAX's --mesh grammar: off/auto/N/DxM, a 1-device resolution is
    None, a bad spec and too many GPUs exit; the CPU mesh is virtual."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    quiet = lambda *a: None  # noqa: E731
    for spec in ("off", "auto", "1", "1x1"):
        assert cli._parse_mesh(spec, quiet, cpu) is None
    assert cli._parse_mesh("64", quiet, cpu).shape == {"data": 64, "model": 1}
    assert cli._parse_mesh("2x4", quiet, cpu).shape == {"data": 2, "model": 4}
    with pytest.raises(SystemExit, match="Invalid --mesh"):
        cli._parse_mesh("4y2", quiet, cpu)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 64 devices but only 1"):
        cli._parse_mesh("64", quiet, gpu)


def _mesh_cli_case(tmp_path, rng, main, extra, name, device=()):
    """One CLI run on the 14-tile scene of tests/test_sharding.py (a fresh
    tiles directory per package, so the analysis caches stay apart)."""
    work = tmp_path / name
    tiles = work / "tiles"
    tiles.mkdir(parents=True)
    for i in range(14):
        arr = rng.integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tiles / f"t{i}.jpg", quality=95)
    src = rng.integers(0, 256, size=(8, 10, 3), dtype=np.uint8)
    Image.fromarray(src).save(work / "s.png")
    out = work / "out.png"
    main(["-o", str(out), "-s", "8", str(work / "s.png"), "mosaic", str(tiles),
          *extra, "--mesh", "4x2", *device])
    with Image.open(out) as a, Image.open(out.with_suffix(".stats.png")) as s:
        return np.asarray(a.convert("RGB")), np.asarray(s.convert("RGB"))


@pytest.mark.parametrize(
    "extra",
    [
        ["-m", "2"],  # dense exact match -> sharded_l1_argmin
        ["-m", "2", "--no-repeat"],  # global greedy -> sharded adaptive / stripes
        ["-m", "2", "--randomize", "25", "--seed", "7"],  # top-k prefix
        ["-m", "1"],  # mode 1 small: the LUT is ineligible either way
    ],
)
def test_cli_mesh_output_identical(tmp_path, devices, monkeypatch, extra):
    """--mesh 4x2 --device cpu: the PNG and the stats PNG equal the JAX
    CLI's --mesh 4x2 on the same scene."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("EMOSAIC_PREP_WORKERS", "0")
    monkeypatch.chdir(tmp_path)
    want = _mesh_cli_case(tmp_path, np.random.default_rng(1234), jax_cli.main, extra, "jax")
    got = _mesh_cli_case(tmp_path, np.random.default_rng(1234), cli.main, extra, "port",
                         ("--device", "cpu"))
    _eq(*zip(got, want))
