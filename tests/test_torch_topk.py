"""Port parity: the exact top-k scorers of `emosaic_tpu_torch.ops.distance`
against the JAX package's, on the same inputs, exactly.

The cases follow `tests/test_ops.py` (the two-level, adaptive, streamed
and audit tests). Where a JAX test patches a budget, the same budget is
patched on both sides. Everything runs on the CPU, so the adaptive
scorer's rescore here is `_l1_rows_ref`, the plain version of K3.
"""

import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as J
from emosaic_tpu_torch.ops import distance as P


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _clustered_case(rng, l=2000, d=48, planted=8):
    lib = rng.integers(100, 256, size=(l, d), dtype=np.uint8)
    q = rng.integers(0, 20, size=(d,), dtype=np.uint8)
    for _ in range(planted):
        lib[rng.integers(0, l)] = np.clip(
            q.astype(np.int32) + rng.integers(0, 3, size=d), 0, 255
        )
    blocks = np.stack([q, np.clip(q + 1, 0, 255).astype(np.uint8)])
    return blocks, lib


def _runs(rng, l, d, b, nbases, jitter=5, noise=3):
    bases = rng.integers(0, 256, size=(nbases, d))
    lib = np.clip(
        np.repeat(bases, -(-l // nbases), axis=0)[:l] + rng.integers(-jitter, jitter + 1, size=(l, d)),
        0, 255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=b)].astype(np.int32)
        + rng.integers(-noise, noise + 1, size=(b, d)), 0, 255,
    ).astype(np.uint8)
    return blocks, lib


def test_l1_block_matches_abs_diff_sum(rng):
    x = rng.integers(0, 256, size=(9, 27), dtype=np.uint8)
    t = rng.integers(0, 256, size=(600, 27), dtype=np.uint8)
    want = np.abs(x.astype(np.int64)[:, None] - t.astype(np.int64)[None]).sum(-1)
    got = P.l1_block(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 group sums (the coarse pass's input) work the same way
    xi = torch.from_numpy(x.astype(np.int32) * 30)
    ti = torch.from_numpy(t.astype(np.int32) * 30)
    np.testing.assert_array_equal(P.l1_block(xi, ti).numpy(), want * 30)


def test_packed_key_selection_breaks_ties_by_lowest_row():
    """torch.topk does not order ties by index; the packed key does."""
    dist = torch.tensor([[3, 1, 1, 0, 0, 5], [7, 7, 7, 7, 7, 7]], dtype=torch.int32)
    dd, rr = P._topk_rows(dist, 3)
    assert rr.tolist() == [[3, 4, 1], [0, 1, 2]]
    assert dd.tolist() == [[0, 0, 1], [7, 7, 7]]


def test_l1_dist_matrix_matches_jax(rng):
    blocks = rng.integers(0, 256, size=(21, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(300, 12), dtype=np.uint8)
    np.testing.assert_array_equal(
        P.l1_dist_matrix(blocks, lib, device="cpu"), np.asarray(J.l1_dist_matrix(blocks, lib))
    )


@pytest.mark.parametrize("k", [1, 11, 300, 400])
def test_l1_topk_stripes_and_matrix_path_match_jax(rng, k):
    pal = rng.integers(0, 256, size=(150, 4, 3), dtype=np.uint8)
    lib = np.array(J.build_library(pal))
    lib[200] = lib[7]  # cross-segment exact tie
    blocks = rng.integers(0, 256, size=(70, 12), dtype=np.uint8)
    blocks[5] = lib[7]
    want = J.l1_topk_stripes(blocks, lib, k)
    _eq(P.l1_topk_stripes(blocks, lib, k, device="cpu"), want)
    _eq(P.l1_topk(blocks, lib, k, device="cpu"), J.l1_topk(blocks, lib, k))
    _eq(P.l1_topk_twolevel(blocks, lib, k, device="cpu"), J.l1_topk_twolevel(blocks, lib, k))


def test_l1_topk_twolevel_tie_storm_falls_back_exactly(rng):
    lib = np.tile(rng.integers(0, 256, size=(1, 12), dtype=np.uint8), (700, 1))
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    d, r = P.l1_topk_twolevel(blocks, lib, 10, device="cpu")
    assert (r == np.arange(10)[None, :]).all()
    _eq((d, r), J.l1_topk_twolevel(blocks, lib, 10))


def test_l1_topk_twolevel_clustered_segment(rng):
    lib = rng.integers(100, 256, size=(640, 12), dtype=np.uint8)
    q = rng.integers(0, 40, size=(12,), dtype=np.uint8)
    for i in range(3 * P._TL_CAP):
        lib[128 + i] = np.clip(q.astype(np.int32) + i % 3, 0, 255)
    blocks = np.stack([q, rng.integers(0, 256, size=(12,), dtype=np.uint8)])
    k = 2 * P._TL_CAP
    _eq(P.l1_topk_twolevel(blocks, lib, k, device="cpu"), J.l1_topk_stripes(blocks, lib, k))


@pytest.mark.parametrize(
    "seed,b,l,d,k", [(0, 33, 129, 3, 1), (1, 64, 400, 12, 20), (2, 17, 1000, 48, 64), (3, 5, 257, 27, 257)]
)
def test_l1_topk_twolevel_fuzz_matches_jax(seed, b, l, d, k):
    r = np.random.default_rng(seed)
    lib = r.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = r.integers(0, 256, size=(b, d), dtype=np.uint8)
    blocks[0] = lib[l // 2]
    _eq(P.l1_topk_twolevel(blocks, lib, k, device="cpu"), J.l1_topk_twolevel(blocks, lib, k))


def test_l1_topk_twolevel_certifies_and_skips_the_fallback(rng, monkeypatch):
    """On clustered data most rows certify: the fallback sees only the
    rest (the path is not all-fallback in disguise)."""
    blocks, lib = _runs(rng, 3000, 48, 40, 30)
    seen = []
    real = P.l1_topk_stripes

    def spy(bb, ll, kk, **kw):
        seen.append(bb.shape[0])
        return real(bb, ll, kk, **kw)

    monkeypatch.setattr(P, "l1_topk_stripes", spy)
    got = P.l1_topk_twolevel(blocks, lib, 8, device="cpu")
    assert sum(seen) < 40
    _eq(got, J.l1_topk_stripes(blocks, lib, 8))


@pytest.mark.parametrize("case", ["clustered", "concentrated", "tie_storm"])
def test_l1_topk_adaptive_matches_jax(rng, case):
    if case == "concentrated":
        lib = rng.integers(0, 256, size=(1500, 48), dtype=np.uint8)
        blocks = rng.integers(0, 256, size=(17, 48), dtype=np.uint8)
        k = 6
    else:
        blocks, lib = _clustered_case(rng, planted=0 if case == "tie_storm" else 8)
        k = 8 if case == "clustered" else 6
        if case == "tie_storm":
            for pos in (3, 700, 1100, 1999):
                lib[pos] = blocks[0]
    want = J.l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    st = {}
    got = P.l1_topk_adaptive(blocks, lib, k, m=32, cap=4, stats=st, device="cpu")
    _eq(got, want)
    _eq(got, J.l1_topk(blocks, lib, k))
    if case == "clustered":
        assert st["route"] == "adaptive" and st["certified"] == 2


def test_l1_topk_adaptive_small_cases_route_to_twolevel(rng):
    lib = rng.integers(0, 256, size=(100, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(5, 12), dtype=np.uint8)
    st = {}
    got = P.l1_topk_adaptive(blocks, lib, 110, stats=st, device="cpu")
    assert st["route"].startswith("twolevel")
    _eq(got, J.l1_topk_adaptive(blocks, lib, 110))


def test_l1_topk_routes_large_through_adaptive(rng, monkeypatch):
    lib = rng.integers(0, 256, size=(900, 48), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(33, 48), dtype=np.uint8)
    monkeypatch.setattr(J, "_TOPK_MATRIX_BUDGET", 100)
    monkeypatch.setattr(P, "_TOPK_MATRIX_BUDGET", 100)
    calls = []
    real = P.l1_topk_adaptive
    monkeypatch.setattr(P, "l1_topk_adaptive", lambda *a, **k: calls.append(1) or real(*a, **k))
    _eq(P.l1_topk(blocks, lib, 7, device="cpu"), J.l1_topk(blocks, lib, 7))
    assert calls


def test_adaptive_k1_argmin_tie_break(rng):
    base = rng.integers(0, 256, size=(1500, 48), dtype=np.uint8)
    lib = base.copy()
    lib[1200:1250] = lib[100:150]
    blocks = lib[rng.integers(0, 1500, size=40)]
    da, ra = P.l1_topk_adaptive(blocks, lib, 1, m=32, cap=4, device="cpu")
    dx, rx = J.l1_argmin_xla(blocks, lib)
    _eq((da[:, 0], ra[:, 0]), (dx, rx))


def test_l1_topk_adaptive_stride_aligned_cluster_stays_exact(rng):
    d, cap, m, k = 48, 4, 32, 8
    l = 4 * P._TL_SEG * 4
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    nseg = l // P._TL_SEG
    q = rng.integers(0, 256, size=(1, d), dtype=np.uint8)
    for i in range(12):
        lib[7 + i * nseg] = np.clip(q[0].astype(np.int32) + (i % 3) - 1, 0, 255)
    blocks = np.vstack([q, rng.integers(0, 256, size=(7, d), dtype=np.uint8)])
    _eq(P.l1_topk_adaptive(blocks, lib, k, m=m, cap=cap, device="cpu"),
        J.l1_topk_adaptive(blocks, lib, k, m=m, cap=cap))


@pytest.mark.parametrize(
    "seed,dist_kind,b,l,d,k,m,cap",
    [
        (0, "clustered", 24, 2200, 48, 8, 64, 8),
        (1, "uniform", 16, 2048, 96, 5, 64, 8),
        (2, "clustered", 9, 3000, 96, 16, 96, 8),
        (3, "dupes", 20, 2500, 24, 32, 64, 8),
    ],
)
def test_l1_topk_adaptive_fuzz_matches_jax(monkeypatch, seed, dist_kind, b, l, d, k, m, cap):
    r = np.random.default_rng(seed)
    if dist_kind == "uniform":
        lib = r.integers(0, 256, size=(l, d), dtype=np.uint8)
    else:
        centers = r.integers(0, 256, size=(8, d))
        lib = np.clip(centers[r.integers(0, 8, l)] + r.normal(0, 9, (l, d)), 0, 255).astype(np.uint8)
        if dist_kind == "dupes":
            lib[l // 2 :] = lib[: l - l // 2]
    blocks = lib[r.integers(0, l, b)].copy()
    blocks[0] = lib[l // 3]
    calls = []
    real = P._ad_coarse
    monkeypatch.setattr(P, "_ad_coarse", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = P.l1_topk_adaptive(blocks, lib, k, m=m, cap=cap, device="cpu")
    assert calls, "shapes rerouted at the entry gate: the fuzz is dead"
    _eq(got, J.l1_topk_stripes(blocks, lib, k))


def test_l1_topk_adaptive_block_slicing_and_sample_gate(rng, monkeypatch):
    """Block slices (one full, one shorter) and the sample gate on
    clustered data: bit-equal to the JAX scorer, and certified."""
    monkeypatch.setattr(J, "_AD_B_SLICE", 256)
    monkeypatch.setattr(P, "_AD_B_SLICE", 256)
    blocks, lib = _runs(rng, 3000, 48, 300, 50)
    seen = []
    real = P._run_block_slices

    def spy(x, b_slice, kk, run):
        seen.append(b_slice)
        return real(x, b_slice, kk, run)

    monkeypatch.setattr(P, "_run_block_slices", spy)
    st = {}
    got = P.l1_topk_adaptive(blocks, lib, 4, m=64, stats=st, device="cpu")
    assert seen == [256] and st["route"] == "adaptive" and st["certified"] == 300
    _eq(got, J.l1_topk_adaptive(blocks, lib, 4, m=64))


def test_l1_topk_adaptive_sample_gate_reroutes_concentrated(rng):
    lib = rng.integers(0, 256, size=(3000, 48), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(200, 48), dtype=np.uint8)
    st = {}
    got = P.l1_topk_adaptive(blocks, lib, 5, m=32, stats=st, device="cpu")
    assert st["route"] == "twolevel (sample gate)"
    _eq(got, J.l1_topk_adaptive(blocks, lib, 5, m=32))


def test_ad_params_and_b_slice_match_jax():
    for nseg in (100, 1563, 2048, 2049, 7813):
        assert P._ad_params(nseg) == J._ad_params(nseg)
    assert P._ad_params(16, 32, 4) == (32, 4)
    for nseg, cap, bc in [(1563, 8, 128), (7813, 8, 128), (15625, 8, 128), (17, 16, 8)]:
        assert P._ad_b_slice(nseg, cap, bc) == J._ad_b_slice(nseg, cap, bc)


def test_ad_plan_matches_jax_on_the_cpu_and_uses_k3_on_cuda():
    for b, l, d, k in [(17, 256, 12, 6), (33, 9000, 48, 4), (33, 9000, 3, 4),
                       (4096, 65534, 3072, 512), (2, 2000, 48, 8)]:
        assert P._ad_plan(b, l, d, k) == J._ad_plan(b, l, d, k)
    # the flagship shape is eligible only where K3 runs
    assert not P._ad_plan(16384, 65534, 3072, 512)[0]
    plan = P._ad_plan(16384, 65534, 3072, 512, device="cuda")
    assert plan[0] and plan[-1] and plan[1:3] == (32, True)


def test_l1_topk_adaptive_prepared_handle_bit_identical(rng):
    blocks, lib = _runs(rng, 2000, 48, 33, 40)
    want = P.l1_topk_adaptive(blocks, lib, 4, m=32, device="cpu")
    handle = P._ad_prepare(lib, 48)
    _eq(P.l1_topk_adaptive(blocks, lib, 4, m=32, prepared=handle, device="cpu"), want)
    _eq(want, J.l1_topk_adaptive(blocks, lib, 4, m=32))
    with pytest.raises(ValueError, match="prepared banks"):
        P.l1_topk_adaptive(blocks, lib[:1500], 4, m=32, prepared=handle, device="cpu")


def test_ad_prepare_declines_ineligible_banks(rng):
    lib = (rng.integers(0, 3, size=(900, 12)) * 16).astype(np.uint8)
    assert P._ad_prepare(lib[:256], 12, 17, 6) is None
    assert P._ad_prepare(lib[:256], 12) is not None
    lib_c = rng.integers(0, 256, size=(9000, 48), dtype=np.uint8)
    assert P._ad_prepare(lib_c, 48, 33, 4) is not None


# ---------------------------------------------------------------------------
# streamed banks
# ---------------------------------------------------------------------------


def test_l1_topk_streamed_ragged_banks_with_ties(rng):
    lib = (rng.integers(0, 3, size=(1000, 12)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(32, 12)) * 16).astype(np.uint8)
    _eq(P.l1_topk_streamed(blocks, lib, 20, bank_rows=256, device="cpu"),
        J.l1_topk_streamed(blocks, lib, 20, bank_rows=256))


def test_l1_topk_streamed_k_exceeds_bank_and_library(rng):
    lib = rng.integers(0, 256, size=(600, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    for k in (300, 1200):
        got = P.l1_topk_streamed(blocks, lib, k, bank_rows=256, device="cpu")
        _eq(got, J.l1_topk_stripes(blocks, lib, k))
    assert (got[0][:, 600:] == P.I32_MAX).all() and (got[1][:, 600:] == 0).all()


def test_fold_topk_host_contract():
    a_d = np.array([[5, 7, P.I32_MAX]], np.int32)
    a_r = np.array([[10, 500, 0]], np.int32)
    b_d = np.array([[5, 6, P.I32_MAX]], np.int32)
    b_r = np.array([[3, 900, 0]], np.int32)
    d0, r0 = P._fold_topk_host(None, None, a_d, a_r, 3, 1000)
    assert d0 is a_d and r0 is a_r
    fd, fr = P._fold_topk_host(d0, r0, b_d, b_r, 3, 1000)
    np.testing.assert_array_equal(fd, [[5, 5, 6]])
    np.testing.assert_array_equal(fr, [[3, 10, 900]])
    _eq((fd, fr), J._fold_topk_host(a_d, a_r, b_d, b_r, 3, 1000))


def test_gates_route_oversized_libraries_to_the_stream(rng, monkeypatch):
    """Past the device budget the adaptive gate, `l1_topk` at small B and
    `l1_argmin` all stream banks, bit-equal to the JAX package under the
    same patched budget."""
    l, d = 3000, 48
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(25, d)) * 16).astype(np.uint8)
    calls = []
    real = P.l1_topk_streamed
    monkeypatch.setattr(P, "l1_topk_streamed", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(J, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    monkeypatch.setattr(P, "DEVICE_LIB_BYTES_MAX", 1024 * d)
    _eq(P.l1_topk_adaptive(blocks, lib, 4, device="cpu"), J.l1_topk_adaptive(blocks, lib, 4))
    assert len(calls) == 1  # gated once; per-bank calls stay direct
    _eq(P.l1_topk(blocks[:5], lib, 6, device="cpu"), J.l1_topk(blocks[:5], lib, 6))
    dd, rr = P.l1_argmin(torch.from_numpy(blocks), torch.from_numpy(lib))
    _eq((dd.numpy(), rr.numpy()), J.l1_argmin_xla(blocks, lib))
    assert len(calls) == 3
    # no blocks: empty results, no recursion between the gates
    empty = np.empty((0, d), np.uint8)
    assert P.l1_topk_adaptive(empty, lib, 5, device="cpu")[0].shape == (0, 5)
    dm, _ = P.l1_argmin(torch.from_numpy(empty), torch.from_numpy(lib))
    assert dm.shape == (0,)


def test_l1_argmin_streams_a_host_library_for_device_blocks(rng, monkeypatch):
    """Over the budget the library may stay on the host while the blocks
    are on the compute device: no devices-differ error."""
    monkeypatch.setattr(P, "DEVICE_LIB_BYTES_MAX", 512 * 12)
    lib = rng.integers(0, 256, size=(1500, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(7, 12), dtype=np.uint8)
    dd, rr = P.l1_argmin(torch.from_numpy(blocks), torch.from_numpy(lib))
    _eq((dd.numpy(), rr.numpy()), J.l1_argmin_xla(blocks, lib))


def test_l1_topk_streamed_custom_scorer_and_prefetch(rng, monkeypatch):
    lib = (rng.integers(0, 3, size=(900, 12)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(17, 12)) * 16).astype(np.uint8)
    got = []

    def scorer(bb, ll, kx, prepared=None):
        got.append(None if prepared is None else prepared[1])
        if prepared is not None:
            assert prepared[0].shape == (-(-ll.shape[0] // 128) * 128, 12)
        return P.l1_topk_stripes(bb, ll, kx)

    scorer.prepare = lambda ll, dd_, b=None, kx=None: P._ad_prepare(ll, dd_)
    want = J.l1_topk_stripes(blocks, lib, 6)
    _eq(P.l1_topk_streamed(blocks, lib, 6, bank_rows=256, scorer=scorer, device="cpu"), want)
    assert got == [256, 256, 256, 132]
    got.clear()
    monkeypatch.setenv("EMOSAIC_STREAM_PREFETCH", "0")
    _eq(P.l1_topk_streamed(blocks, lib, 6, bank_rows=256, scorer=scorer, device="cpu"), want)
    assert got == [None] * 4


def test_l1_topk_streamed_bank_sizing(rng, monkeypatch, capsys):
    """Automatic banks halve under prefetch; explicit banks that do not
    fit twice go serial, loudly; results bit-equal throughout."""
    l, d = 3000, 48
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    monkeypatch.setattr(P, "DEVICE_LIB_BYTES_MAX", 1024 * d)
    seen, handles = [], []

    def scorer(bb, ll, kx, prepared=None):
        seen.append(ll.shape[0])
        handles.append(prepared is not None)
        return P.l1_topk_stripes(bb, ll, kx)

    scorer.prepare = lambda ll, dd_, b=None, kx=None: P._ad_prepare(ll, dd_)
    want = J.l1_topk_stripes(blocks, lib, 3)
    _eq(P.l1_topk_streamed(blocks, lib, 3, scorer=scorer, device="cpu"), want)
    assert seen == [512] * 5 + [440]
    seen.clear(), handles.clear()
    _eq(P.l1_topk_streamed(blocks, lib, 3, bank_rows=1024, scorer=scorer, device="cpu"), want)
    assert handles == [False] * 3
    assert "prefetch disabled" in capsys.readouterr().err
    handles.clear()
    _eq(P.l1_topk_streamed(blocks, lib, 3, bank_rows=512, scorer=scorer, device="cpu"), want)
    assert handles == [True] * 6


def test_l1_topk_streamed_prefetch_error_propagates(rng):
    lib = rng.integers(0, 256, size=(600, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(4, 12), dtype=np.uint8)

    def scorer(bb, ll, kx, prepared=None):
        return P.l1_topk_stripes(bb, ll, kx)

    def bad_prepare(ll, dd, b=None, kx=None):
        raise RuntimeError("prefetch boom")

    scorer.prepare = bad_prepare
    with pytest.raises(RuntimeError, match="prefetch boom"):
        P.l1_topk_streamed(blocks, lib, 3, bank_rows=256, scorer=scorer, device="cpu")


def test_streamed_dispatch_fuzz_matches_jax(rng):
    for trial in range(6):
        l = int(rng.integers(10, 1200))
        d = int(rng.integers(1, 5)) * 3
        b = int(rng.integers(1, 33))
        k = int(rng.integers(1, min(l, 600) + 1))
        card = int(rng.integers(2, 9))
        q = 255 // (card - 1)
        lib = (rng.integers(0, card, size=(l, d)) * q).astype(np.uint8)
        blocks = (rng.integers(0, card, size=(b, d)) * q).astype(np.uint8)
        bank = int(rng.integers(1, 9)) * P._TL_SEG
        _eq(P.l1_topk_streamed(blocks, lib, k, bank_rows=bank, device="cpu"),
            J.l1_topk_stripes(blocks, lib, k))


def test_stream_bank_rows_follow_the_device_budget():
    for d in (12, 48, 768, 3072, 49152):
        rb = P._stream_bank_rows(d)
        assert rb % P._TL_SEG == 0 and rb * d <= max(P.DEVICE_LIB_BYTES_MAX, P._TL_SEG * d)
    assert P._stream_bank_rows(3072) == P.DEVICE_LIB_BYTES_MAX // 3072 // 128 * 128


# ---------------------------------------------------------------------------
# certificate self-audit
# ---------------------------------------------------------------------------


def test_stripes_banked_matches_stripe_scorer(rng, monkeypatch):
    l, d = 1000, 16
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    monkeypatch.setattr(P, "_AUDIT_CHUNK_BYTES", 1)  # 128-row chunks
    lib_pad = torch.zeros((1024, d), dtype=torch.uint8)
    lib_pad[:l] = torch.from_numpy(lib)
    got = P._stripes_banked(torch.from_numpy(blocks), lib_pad, l, d, 200)
    _eq(got, J.l1_topk_stripes(blocks, lib, 200))


def test_adaptive_audit_catches_certified_lie(rng, monkeypatch, capsys):
    blocks, lib = _clustered_case(rng)
    real = P._ad_rescore

    def lying_rescore(x, keys, s_min, lib_pad, **kw):
        dd, rr, ok = real(x, keys, s_min, lib_pad, **kw)
        return dd + 1, (rr + 1) % kw["real_l"], torch.ones_like(ok)

    monkeypatch.setattr(P, "_ad_rescore", lying_rescore)
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    st = {}
    got = P.l1_topk_adaptive(blocks, lib, 8, m=32, cap=4, stats=st, device="cpu")
    _eq(got, J.l1_topk(blocks, lib, 8))
    assert st["audit"] and "EXACTNESS AUDIT FAILED" in capsys.readouterr().err


def test_adaptive_audit_projection_displacement_stays_exact(rng, monkeypatch):
    """The JAX package's round-4 fault class (every projection chunk held
    the last chunk's values), injected into the port's coarse library:
    the results stay exact, whichever layer catches it."""
    blocks, lib = _clustered_case(rng)
    real = P._ad_coarse_lib

    def displaced(lib_pad, d, g, chan, real_l):
        proj, cols, invalid = real(lib_pad, d, g, chan, real_l)
        n8 = proj.shape[0] // 8
        return torch.cat([proj[-n8:]] * 8), cols, invalid

    monkeypatch.setattr(P, "_ad_coarse_lib", displaced)
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    _eq(P.l1_topk_adaptive(blocks, lib, 8, m=32, cap=4, device="cpu"), J.l1_topk(blocks, lib, 8))


def test_adaptive_audit_gating(rng, monkeypatch, capsys):
    blocks, lib = _clustered_case(rng)
    want_d, _ = J.l1_topk(blocks, lib, 8)
    real = P._ad_rescore

    def lying_rescore(x, keys, s_min, lib_pad, **kw):
        dd, rr, ok = real(x, keys, s_min, lib_pad, **kw)
        return dd + 1, rr, torch.ones_like(ok)

    monkeypatch.setattr(P, "_ad_rescore", lying_rescore)
    got_d, _ = P.l1_topk_adaptive(blocks, lib, 8, m=32, cap=4, device="cpu")
    assert (got_d == want_d + 1).all()  # below the row threshold: no audit
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    monkeypatch.setenv("EMOSAIC_AUDIT", "0")
    got_d, _ = P.l1_topk_adaptive(blocks, lib, 8, m=32, cap=4, device="cpu")
    assert (got_d == want_d + 1).all()
    assert "EXACTNESS AUDIT" not in capsys.readouterr().err
    assert P._audit_would_run(P._AUDIT_MIN_ROWS, 1, 1) == J._audit_would_run(J._AUDIT_MIN_ROWS, 1, 1)


# ---------------------------------------------------------------------------
# the device a host-array call runs on
# ---------------------------------------------------------------------------

#: the nine public scorers, (port call, JAX call), on [B, D] blocks and an
#: [L, D] library; L = 200 <= 256 keeps the hybrid on its exact stripes
_PUBLIC_SCORERS = {
    "l1_topk_stripes": (lambda b, l, **kw: P.l1_topk_stripes(b, l, 5, **kw),
                        lambda b, l: J.l1_topk_stripes(b, l, 5)),
    "l1_dist_matrix": (lambda b, l, **kw: (P.l1_dist_matrix(b, l, **kw),) * 2,
                       lambda b, l: (np.asarray(J.l1_dist_matrix(b, l)),) * 2),
    "l1_topk": (lambda b, l, **kw: P.l1_topk(b, l, 5, **kw),
                lambda b, l: J.l1_topk(b, l, 5)),
    "l1_topk_twolevel": (lambda b, l, **kw: P.l1_topk_twolevel(b, l, 5, **kw),
                         lambda b, l: J.l1_topk_twolevel(b, l, 5)),
    "l1_topk_adaptive": (lambda b, l, **kw: P.l1_topk_adaptive(b, l, 5, **kw),
                         lambda b, l: J.l1_topk_adaptive(b, l, 5)),
    "l1_topk_streamed": (lambda b, l, **kw: P.l1_topk_streamed(b, l, 5, bank_rows=128, **kw),
                         lambda b, l: J.l1_topk_streamed(b, l, 5, bank_rows=128)),
    "l1_topk_hybrid": (lambda b, l, **kw: P.l1_topk_hybrid(b, l, 5, **kw),
                       lambda b, l: J.l1_topk_hybrid(b, l, 5)),
    "l1_argmin_hybrid": (lambda b, l, **kw: P.l1_argmin_hybrid(b, l, **kw),
                         lambda b, l: J.l1_argmin_hybrid(b, l)),
    "l2_argmin": (lambda b, l, **kw: P.l2_argmin(b, l, **kw),
                  lambda b, l: J.l2_argmin(b, l)),
}


@pytest.mark.parametrize("name", sorted(_PUBLIC_SCORERS))
def test_host_arrays_run_on_the_card_unless_the_cpu_is_asked_for(rng, monkeypatch, name):
    """A host-array call with no `device` runs on `cuda`, so it raises where
    no GPU is visible; `device="cpu"` equals the JAX scorer; a tensor keeps
    its own device."""
    port, jax_call = _PUBLIC_SCORERS[name]
    lib = rng.integers(0, 256, size=(200, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        port(blocks, lib)
    want = jax_call(blocks, lib)
    _eq(port(blocks, lib, device="cpu"), want)
    _eq(port(torch.from_numpy(blocks), torch.from_numpy(lib)), want)


def test_device_of_prefers_the_asked_device_then_the_tensor(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert P._device_of(np.zeros((1, 3), np.uint8), None) == torch.device("cuda")
    assert P._device_of(np.zeros((1, 3), np.uint8), "cpu") == torch.device("cpu")
    assert P._device_of(torch.zeros((1, 3), dtype=torch.uint8), None) == torch.device("cpu")


# K10's fused stage 1 (`l1_topcap`, plain version `_l1_topcap_ref` on the
# CPU) against the per-segment stage computed from the JAX package's
# `l1_dist_matrix`, and the routes that now run it.


def _jax_stage1(x, t, cap, col0, real_l):
    """Each 128-column segment's cap least (distance << 32) | col keys,
    ascending, from the JAX package's dense matrix: the last segment's
    missing columns and the cols at or past real_l are I32_MAX."""
    dist = np.asarray(J.l1_dist_matrix(x, t)).astype(np.int64)
    l = t.shape[0]
    nseg = -(-l // 128)
    dist = np.pad(dist, ((0, 0), (0, nseg * 128 - l)), constant_values=P.I32_MAX)
    cols = np.arange(col0, col0 + nseg * 128, dtype=np.int64)
    dist[:, cols >= real_l] = P.I32_MAX
    keys = (dist << 32) | cols
    return np.sort(keys.reshape(x.shape[0], nseg, 128), axis=-1)[:, :, :cap]


@pytest.mark.parametrize(
    "kind,r,l,d,cap,col0,real_l",
    [
        ("ragged", 21, 300, 12, 8, 0, None),        # L not a multiple of 128
        ("tie_storm", 9, 700, 12, 8, 0, None),      # equal distances across the cap
        ("tie_storm", 5, 256, 48, 33, 0, None),     # ... and on the rank path
        ("uniform", 17, 257, 3, 8, 0, None),        # D = 3
        ("uniform", 11, 400, 50, 16, 0, None),      # D = 50
        ("uniform", 13, 384, 12, 1, 0, None),       # caps 1, 8, 16, 33
        ("uniform", 13, 384, 12, 16, 0, None),
        ("uniform", 7, 384, 27, 33, 0, None),
        ("shard", 15, 256, 12, 8, 1000, 1200),      # col0 > 0, real_l inside
        ("shard", 6, 300, 48, 16, 64, 300),         # real_l in the last but one segment
    ],
)
def test_l1_topcap_ref_matches_jax_stage1(kind, r, l, d, cap, col0, real_l):
    rng = np.random.default_rng(r * 31 + l + d + cap)
    if kind == "tie_storm":
        t = np.tile(rng.integers(0, 256, size=(3, d), dtype=np.uint8), (-(-l // 3), 1))[:l]
    else:
        t = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    x = rng.integers(0, 256, size=(r, d), dtype=np.uint8)
    x[0] = t[l // 2]
    real = col0 + l if real_l is None else real_l
    want = _jax_stage1(x, t, cap, col0, real)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got = P._l1_topcap_ref(xt, tt, cap, col0, real)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.l1_topcap(xt, tt, cap, col0=col0, real_l=real_l).numpy(),
                                  want)


def test_l1_topcap_validation():
    x = torch.zeros((2, 12), dtype=torch.uint8)
    t = torch.zeros((300, 12), dtype=torch.uint8)
    for bad, exc in [
        (lambda: P.l1_topcap(x.int(), t, 8), TypeError),
        (lambda: P.l1_topcap(x, t[:, :6], 8), ValueError),
        (lambda: P.l1_topcap(x, t[:0], 8), ValueError),
        (lambda: P.l1_topcap(x, t, 0), ValueError),
        (lambda: P.l1_topcap(x, t, 129), ValueError),
        (lambda: P.l1_topcap(x, t, 8, col0=2**31 - 300), ValueError),
    ]:
        with pytest.raises(exc):
            bad()
    assert P.l1_topcap(x[:0], t, 8).shape == (0, 3, 8)


def test_l1_block_checks_shapes_and_devices():
    x = torch.zeros((2, 12), dtype=torch.uint8)
    with pytest.raises(ValueError):
        P.l1_block(x, torch.zeros((5, 11), dtype=torch.uint8))
    with pytest.raises(ValueError):
        P.l1_block(x, torch.zeros((5, 12), dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize(
    "seed,b,l,d,k", [(4, 40, 1000, 48, 12), (5, 37, 1500, 12, 16), (6, 12, 2000, 50, 10)]
)
def test_l1_topk_twolevel_partial_certification_matches_jax(monkeypatch, seed, b, l, d, k):
    """A run of rows near one colour inside one segment holds more than
    the cap of its blocks' nearest rows, so those blocks fail the
    certificate (the stripe fallback runs for them alone); blocks of
    uniform noise, whose nearest rows spread over the segments, pass."""
    r = np.random.default_rng(seed)
    lib = r.integers(0, 256, size=(l, d), dtype=np.uint8)
    base = r.integers(0, 256, size=d)
    lib[300 : 300 + 3 * P._TL_CAP] = np.clip(base + r.integers(-2, 3, (3 * P._TL_CAP, d)), 0, 255)
    blocks = r.integers(0, 256, size=(b, d), dtype=np.uint8)
    blocks[: b // 2] = np.clip(base + r.integers(-2, 3, (b // 2, d)), 0, 255)
    seen = []
    real = P.l1_topk_stripes
    monkeypatch.setattr(P, "l1_topk_stripes",
                        lambda bb, ll, kk, **kw: seen.append(bb.shape[0]) or real(bb, ll, kk, **kw))
    got = P.l1_topk_twolevel(blocks, lib, k, device="cpu")
    assert 0 < sum(seen) < b
    _eq(got, J.l1_topk_twolevel(blocks, lib, k))
    _eq(got, J.l1_topk_stripes(blocks, lib, k))


def test_l1_topk_worst_case_reroute_matches_jax(rng, monkeypatch):
    """Uniform data past the dense budget: `l1_topk` takes the adaptive
    scorer, whose sample gate reroutes to the two-level scorer (the
    flagship's worst case, at a small size)."""
    lib = rng.integers(0, 256, size=(8400, 48), dtype=np.uint8)  # past 1024 / 16 segments
    blocks = rng.integers(0, 256, size=(140, 48), dtype=np.uint8)
    blocks[3] = lib[1000]
    lib[8300] = lib[1000]  # a tie across segments
    monkeypatch.setattr(J, "_TOPK_MATRIX_BUDGET", 1000)
    monkeypatch.setattr(P, "_TOPK_MATRIX_BUDGET", 1000)
    st = {}
    got = P.l1_topk(blocks, lib, 20, device="cpu", stats=st)
    assert st["route"] == "twolevel (sample gate)"
    _eq(got, J.l1_topk(blocks, lib, 20))
    _eq(got, J.l1_topk_stripes(blocks, lib, 20))


def test_twolevel_chunks_follow_the_survivor_budget(rng, monkeypatch):
    """The chunk is bounded by the [rows, nseg, cap] survivor keys, not by a
    [rows, L] stripe: a small budget gives several chunks, same lists."""
    lib = rng.integers(0, 256, size=(700, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(30, 12), dtype=np.uint8)
    want = P.l1_topk_twolevel(blocks, lib, 9, device="cpu")
    assert P._twolevel_rows(6, 8) == P._AD_SURV_BYTES // (8 * 6 * 8)
    monkeypatch.setattr(P, "_AD_SURV_BYTES", 8 * 6 * 8 * 7)
    assert P._twolevel_rows(6, 8) == 7
    calls = []
    real = P.l1_topcap
    monkeypatch.setattr(P, "l1_topcap", lambda x, *a, **kw: calls.append(x.shape[0]) or real(x, *a, **kw))
    _eq(P.l1_topk_twolevel(blocks, lib, 9, device="cpu"), want)
    assert calls == [7, 7, 7, 7, 2]
