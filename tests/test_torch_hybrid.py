"""Port parity: the hybrid and L2 matchers against the JAX package, on the
same seeded numpy inputs, on the CPU.

`l2_argmin` (direct and streamed), `l1_topk_hybrid` / `l1_argmin_hybrid`
(the L2 prefilter and the exact-L1 rescore on K3's plain version),
`match_blocks`' dispatch and `render_nto1_no_repeat(scorer="hybrid")`.
Every case is at D <= 192, where the f32 scores are exact integers. The
JAX prefilter's `approx_min_k` returns the exact k_pre least scores on the
CPU but leaves the order among equal scores unspecified, so which of the
tied rows it keeps at the cut follows no rule; the port keeps the lowest.
The parity cases use data whose scores have no tie across the
prefilter's cut (`_assert_no_tie_at_cut` checks it). The tied-data cases
(`test_tied_*`) pin what both packages agree on where ties cross the cut:
the multiset of selected scores, exact L1 distances of their own rows in
(distance, row) order, and equal results for every query whose tie group
lies wholly inside the cut; the rest is the accepted divergence the
README records.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as J
from emosaic_tpu.render import matched as jax_matched
from emosaic_tpu.render import norepeat as jax_norepeat
from emosaic_tpu.tiles.tileset import TileSet as JaxTileSet
from emosaic_tpu_torch.ops import distance as P
from emosaic_tpu_torch.ops.analysis import source_blocks
from emosaic_tpu_torch.render import matched, norepeat
from emosaic_tpu_torch.tiles.tileset import TileSet

quiet = dict(log=lambda *a: None)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scores(blocks, lib):
    """The exact squared-L2 prefilter score |t|^2 - 2 x.t, int64."""
    t = lib.astype(np.int64)
    return (t * t).sum(1)[None, :] - 2 * blocks.astype(np.int64) @ t.T


def _assert_no_tie_at_cut(blocks, lib, kp):
    s = np.sort(_scores(blocks, lib), axis=1)
    assert (s[:, kp - 1] != s[:, kp]).all(), "the data ties across the prefilter cut"


@pytest.mark.parametrize("n_cells", [1, 4, 64])
def test_l2_argmin_oracle_and_jax(rng, n_cells):
    pal = rng.integers(0, 256, size=(60, n_cells, 3), dtype=np.uint8)
    lib = np.asarray(J.build_library(pal))
    blocks = rng.integers(0, 256, size=(33, n_cells * 3), dtype=np.uint8)
    dist, row = P.l2_argmin(_t(blocks), _t(lib))
    assert dist.dtype == row.dtype == np.int32
    full = ((blocks.astype(np.int64)[:, None] - lib.astype(np.int64)[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(dist, full[np.arange(33), row])
    np.testing.assert_array_equal(dist, full.min(1))
    jd, jr = J.l2_argmin(blocks, lib)
    np.testing.assert_array_equal(dist, np.asarray(jd))
    np.testing.assert_array_equal(row, np.asarray(jr))


def test_l2_argmin_first_minimum_and_library_chunks(rng, monkeypatch):
    """Equal scores go to the first row, also across the library chunks
    of the f32 product."""
    base = rng.integers(0, 256, size=(50, 12), dtype=np.uint8)
    lib = np.concatenate([base, base, base])  # each row three times
    blocks = rng.integers(0, 256, size=(40, 12), dtype=np.uint8)
    want = P.l2_argmin(_t(blocks), _t(lib))
    monkeypatch.setattr(P, "_BLOCK_F32_BYTES", 4 * 12 * 7)  # 7-row chunks
    got = P.l2_argmin(_t(blocks), _t(lib))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] < 50).all()
    jd, jr = J.l2_argmin(blocks, lib)
    np.testing.assert_array_equal(got[1], np.asarray(jr))


def test_l2_argmin_streams_beyond_budget(rng, monkeypatch):
    """Past the budget (3x the library) the L2 argmin streams banks of a
    third of it through itself and agrees with the direct run, as the JAX
    package's does; a tiny budget floors the banks at 128 rows."""
    l, d = 2000, 12
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(23, d), dtype=np.uint8)
    d_ref, r_ref = P.l2_argmin(_t(blocks), _t(lib))
    calls = []
    real = P.l1_topk_streamed
    monkeypatch.setattr(P, "l1_topk_streamed", lambda *a, **k: calls.append(k) or real(*a, **k))
    for budget in (512 * d * 3, 1):
        monkeypatch.setattr(P, "DEVICE_LIB_BYTES_MAX", budget)
        d_s, r_s = P.l2_argmin(_t(blocks), _t(lib))
        np.testing.assert_array_equal(d_s, d_ref)
        np.testing.assert_array_equal(r_s, r_ref)
    assert [c["bank_rows"] for c in calls] == [512, 128]
    monkeypatch.setattr(J, "_DEVICE_LIB_BYTES_MAX", 512 * d * 3)
    jd, jr = J.l2_argmin(blocks, lib)
    np.testing.assert_array_equal(d_ref, np.asarray(jd))
    np.testing.assert_array_equal(r_ref, np.asarray(jr))


def test_l1_topk_hybrid_small_library_is_exact(rng):
    pal = rng.integers(0, 256, size=(20, 4, 3), dtype=np.uint8)
    lib = np.asarray(J.build_library(pal))
    blocks = rng.integers(0, 256, size=(50, 12), dtype=np.uint8)
    d_h, r_h = P.l1_topk_hybrid(_t(blocks), _t(lib), 5)
    d_m, r_m = P.l1_topk(_t(blocks), _t(lib), 5)
    np.testing.assert_array_equal(d_h, d_m)
    np.testing.assert_array_equal(r_h, r_m)
    jd, jr = J.l1_topk_hybrid(blocks, lib, 5)
    np.testing.assert_array_equal(d_h, jd)
    np.testing.assert_array_equal(r_h, jr)


@pytest.mark.parametrize("l,d,b,k,k_pre", [(600, 27, 40, 1, 64), (1500, 48, 30, 6, None),
                                           (900, 192, 12, 20, 100)])
def test_l1_topk_hybrid_matches_jax(rng, l, d, b, k, k_pre):
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    kp = min(k_pre or max(2 * k, 64), l)
    _assert_no_tie_at_cut(blocks, lib, kp)
    d_h, r_h = P.l1_topk_hybrid(_t(blocks), _t(lib), k, k_pre=k_pre)
    jd, jr = J.l1_topk_hybrid(blocks, lib, k, k_pre=k_pre)
    np.testing.assert_array_equal(d_h, jd)
    np.testing.assert_array_equal(r_h, jr)
    exact = np.abs(blocks.astype(np.int64)[:, None] - lib.astype(np.int64)[None]).sum(-1)
    np.testing.assert_array_equal(d_h, np.take_along_axis(exact, r_h.astype(np.int64), 1))
    assert (np.diff(d_h, axis=1) >= 0).all()


def test_l1_argmin_hybrid_matches_jax(rng):
    lib = rng.integers(0, 256, size=(600, 27), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(40, 27), dtype=np.uint8)
    _assert_no_tie_at_cut(blocks, lib, 64)
    d_h, r_h = P.l1_argmin_hybrid(_t(blocks), _t(lib))
    jd, jr = J.l1_argmin_hybrid(blocks, lib)
    np.testing.assert_array_equal(d_h, np.asarray(jd))
    np.testing.assert_array_equal(r_h, np.asarray(jr))
    brute = np.abs(blocks.astype(np.int64)[:, None] - lib.astype(np.int64)[None]).sum(-1)
    assert (r_h == brute.argmin(1)).mean() > 0.9


@pytest.mark.parametrize("l", [17000, 20000])
def test_l1_topk_hybrid_arbitrary_library_sizes(monkeypatch, l):
    """Library sizes off any power of two, across the f32 product's
    library chunks: equal to the JAX hybrid, distances exact."""
    rng = np.random.default_rng(l)  # a seed whose data has no tie at the cut
    lib = rng.integers(0, 256, size=(l, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    _assert_no_tie_at_cut(blocks, lib, 64)
    monkeypatch.setattr(P, "_BLOCK_F32_BYTES", 4 * 12 * 5000)
    d, r = P.l1_topk_hybrid(_t(blocks), _t(lib), 2)
    jd, jr = J.l1_topk_hybrid(blocks, lib, 2)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(r, jr)
    ref = np.abs(blocks.astype(np.int64) - lib[r[:, 0]].astype(np.int64)).sum(-1)
    assert (d[:, 0] == ref).all() and (d[:, 0] <= d[:, 1]).all()


def test_l1_topk_hybrid_oversized_library_streams_exact(rng, monkeypatch):
    l, d, k = 3000, 48, 7
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(21, d), dtype=np.uint8)
    d_o, r_o = P.l1_topk_stripes(_t(blocks), _t(lib), k)
    monkeypatch.setattr(P, "DEVICE_LIB_BYTES_MAX", 1024 * d)
    d_h, r_h = P.l1_topk_hybrid(_t(blocks), _t(lib), k)
    np.testing.assert_array_equal(d_h, d_o)
    np.testing.assert_array_equal(r_h, r_o)
    monkeypatch.setattr(J, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    jd, jr = J.l1_topk_hybrid(blocks, lib, k)
    np.testing.assert_array_equal(d_h, jd)
    np.testing.assert_array_equal(r_h, jr)


def test_l2_prefilter_breaks_ties_by_lowest_row(monkeypatch):
    """Equal scores: the lowest rows win the cut, also across library
    chunks (where JAX's approx_min_k would pick any of them)."""
    row = np.full((1, 12), 9, np.uint8)
    lib = np.concatenate([np.zeros((10, 12), np.uint8), np.repeat(row, 300, 0)])
    blocks = np.full((2, 12), 9, np.uint8)
    monkeypatch.setattr(P, "_BLOCK_F32_BYTES", 4 * 12 * 64)
    cand = P._l2_prefilter(_t(blocks), _t(lib), 20)
    np.testing.assert_array_equal(np.sort(cand.numpy(), 1), np.tile(np.arange(10, 30), (2, 1)))


def _tied(case):
    """(blocks [32, 12], lib) whose squared-L2 scores tie across a cut of 64.
    "pairs": 300 random rows, half of them listed twice, shuffled, so the
    cut splits a pair for some queries and not for others. "storm": 100
    copies of one row scattered among 300 others, and blocks near that row,
    so a group of 100 equal scores straddles the cut for every query."""
    rng = np.random.default_rng(6)
    base = rng.integers(0, 256, size=(300, 12), dtype=np.uint8)
    if case == "pairs":
        lib = np.concatenate([base, base[:150]])
        blocks = rng.integers(0, 256, size=(32, 12), dtype=np.uint8)
    else:
        lib = np.concatenate([base, np.repeat(base[:1], 100, 0)])
        noise = rng.integers(-3, 4, size=(32, 12))
        blocks = np.clip(base[0].astype(int) + noise, 0, 255).astype(np.uint8)
    return blocks, lib[rng.permutation(len(lib))]


def _crossing(blocks, lib, kp):
    """Per query: whether equal scores straddle the cut at kp."""
    s = np.sort(_scores(blocks, lib), axis=1)
    return s[:, kp - 1] == s[:, kp]


@pytest.mark.parametrize("case", ["pairs", "storm"])
def test_tied_prefilter_selects_the_same_scores_and_the_lowest_rows(case):
    """(a) The port's k_pre selected scores equal, as a multiset, those of
    the JAX prefilter's approx_min_k; (b) among tied scores the port keeps
    the lowest rows: its set is the k_pre least by (score, row)."""
    import jax.numpy as jnp

    kp = 64
    blocks, lib = _tied(case)
    crossing = _crossing(blocks, lib, kp)
    assert crossing.any()
    if case == "pairs":
        assert not crossing.all()
    exact = _scores(blocks, lib)
    got = P._l2_prefilter(_t(blocks), _t(lib), kp).numpy()
    want = np.asarray(J._mxu_prefilter_jit(
        jnp.asarray(blocks.reshape(-1)), jnp.asarray(lib.reshape(-1)), d=12, bc=32, k_pre=kp))
    np.testing.assert_array_equal(np.sort(np.take_along_axis(exact, got.astype(np.int64), 1), 1),
                                  np.sort(np.take_along_axis(exact, want.astype(np.int64), 1), 1))
    rows = np.arange(lib.shape[0])
    for i in range(blocks.shape[0]):
        lowest = np.lexsort((rows, exact[i]))[:kp]
        np.testing.assert_array_equal(np.sort(got[i]), np.sort(lowest))


@pytest.mark.parametrize("case", ["pairs", "storm"])
def test_tied_hybrid_is_exact_and_agrees_inside_the_cut(case):
    """(c) Both packages' `l1_topk_hybrid` return the exact L1 distances of
    their own rows in (distance, row) order; where the tie group lies wholly
    inside the cut the rows and distances are equal. In the storm every
    query's top k are copies of one row, so the distances agree though the
    rows may not."""
    kp, k = 64, 5
    blocks, lib = _tied(case)
    crossing = _crossing(blocks, lib, kp)
    d_p, r_p = P.l1_topk_hybrid(_t(blocks), _t(lib), k, k_pre=kp)
    d_j, r_j = (np.asarray(a) for a in J.l1_topk_hybrid(blocks, lib, k, k_pre=kp))
    l1 = np.abs(blocks.astype(np.int64)[:, None] - lib.astype(np.int64)[None]).sum(-1)
    for d_, r_ in ((d_p, r_p), (d_j, r_j)):
        np.testing.assert_array_equal(d_, np.take_along_axis(l1, r_.astype(np.int64), 1))
        for i in range(len(d_)):
            pairs = list(zip(d_[i].tolist(), r_[i].tolist()))
            assert pairs == sorted(pairs)
    inside = ~crossing
    np.testing.assert_array_equal(d_p[inside], d_j[inside])
    np.testing.assert_array_equal(r_p[inside], r_j[inside])
    if case == "storm":
        np.testing.assert_array_equal(d_p, d_j)


def test_full_f32_restores_the_precision_setting():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with P._full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def _sets(pal):
    paths = [f"tiles/t{i}.jpg" for i in range(len(pal))]
    return TileSet.from_arrays(pal, paths), JaxTileSet(
        palettes=pal, paths=[Path(p) for p in paths]
    )


@pytest.mark.parametrize(
    "kw,route",
    [(dict(metric="l2"), "l2"), (dict(hybrid=True), "hybrid"),
     (dict(hybrid=True, use_lut="never"), "hybrid")],
)
def test_match_blocks_dispatch_matches_jax(rng, monkeypatch, kw, route):
    pal = rng.integers(0, 256, size=(400, 4, 3), dtype=np.uint8)
    lib = np.asarray(J.build_library(pal))
    blocks = rng.integers(0, 256, size=(64, 12), dtype=np.uint8)
    _assert_no_tie_at_cut(blocks, lib, 64)
    seen = []
    for name in ("l2_argmin", "l1_argmin_hybrid"):
        real = getattr(matched, name)
        monkeypatch.setattr(matched, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or _r(*a, **k))
    got = matched.match_blocks(_t(blocks), _t(lib), **kw)
    assert seen == [{"l2": "l2_argmin", "hybrid": "l1_argmin_hybrid"}[route]]
    want = jax_matched.match_blocks(blocks, lib, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_match_blocks_hybrid_in_mode_1_stays_exact(rng, monkeypatch):
    """At D = 3 the hybrid flag is ignored, as in the JAX package."""
    lib = rng.integers(0, 256, size=(500, 3), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(100, 3), dtype=np.uint8)
    monkeypatch.setattr(matched, "l1_argmin_hybrid", None)
    got = matched.match_blocks(_t(blocks), _t(lib), hybrid=True)
    want = P.l1_argmin_ref(_t(blocks), _t(lib))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("kw", [dict(metric="l2"), dict(hybrid=True)])
def test_render_nto1_fast_modes_match_jax(rng, kw):
    pal = rng.integers(0, 256, size=(300, 4, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(300, 8, 8, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    if kw.get("hybrid"):
        lib = np.asarray(J.build_library(pal))
        _assert_no_tie_at_cut(source_blocks(src, 2, device="cpu").numpy(), lib, 64)
    want = jax_matched.render_nto1(src, jts, 8, stack=stack, **kw, **quiet)
    got = matched.render_nto1(src, ts, 8, stack=stack, device="cpu", **kw, **quiet)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.stats.render(8), want.stats.render(8))


def test_render_nto1_no_repeat_hybrid_matches_jax(rng, monkeypatch):
    """The hybrid scorer route past the full-list budget (set to 0 in both
    packages, with k = 8 and so k_pre = 16), items, image and stats."""
    pal = rng.integers(0, 256, size=(200, 4, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)  # 80 blocks
    stack = rng.integers(1, 256, size=(200, 8, 8, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    for mod in (norepeat, jax_norepeat):
        monkeypatch.setattr(mod, "_EXACT_BUDGET", 0)
        monkeypatch.setattr(mod, "_TRUNCATED_K", 8)
    lib = np.asarray(J.build_library(pal))
    _assert_no_tie_at_cut(source_blocks(src, 2, device="cpu").numpy(), lib, 16)
    calls = []
    real = norepeat.l1_topk_hybrid
    monkeypatch.setattr(norepeat, "l1_topk_hybrid", lambda *a, **k: calls.append(k) or real(*a, **k))
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 8, stack=stack, scorer="hybrid", **quiet)
    got = norepeat.render_nto1_no_repeat(src, ts, 8, device="cpu", stack=stack,
                                         scorer="hybrid", **quiet)
    assert got.info["scorer"] == "hybrid" and calls == [dict(k_pre=16)]
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.stats.render(8), want.stats.render(8))
    items = got.items.reshape(-1)
    assert len(set(np.abs(items).tolist())) == items.size
