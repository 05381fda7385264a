"""K11's plain versions and the L2 routes on the CPU: the squared-L2 argmin
(`_l2_argmin`, plain version `_l2_argmin_ref`), the fused per-segment
top-cap (`l2_topcap`, plain version `_l2_topcap_ref`) and the hybrid's
prefilter built on it (`_l2_prefilter`: stage 1, `_certified_least`, and
whole segments for uncertified rows).

At D <= 258 the JAX package's f32 scores are exact integers, so its
`_l2_argmin_jit` and `_mxu_prefilter_jit` give the same rows (the
prefilter's set wherever no tie crosses its cut). At larger D the port's
order is the exact one, held against a numpy int64 oracle, also past
D = 33025 where the top-cap keys carry dist^2 - 2^31.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_l2_score.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as J
from emosaic_tpu_torch.ops import distance as P


def _t(x):
    return torch.from_numpy(np.array(x))


def _sq(blocks, lib):
    """Exact squared distances, int64 [B, L]."""
    x, t = blocks.astype(np.int64), lib.astype(np.int64)
    return (x * x).sum(1)[:, None] + (t * t).sum(1)[None, :] - 2 * x @ t.T


def _least_rows(d2, k):
    """The k least (distance, row) rows of each row of d2, ascending."""
    rows = np.arange(d2.shape[1])
    return np.stack([np.lexsort((rows, d2[i]))[:k] for i in range(len(d2))])


def _no_tie_at_cut(blocks, lib, kp):
    s = np.sort(_sq(blocks, lib), axis=1)
    return (s[:, kp - 1] != s[:, kp]).all()


def _topcap_oracle(blocks, lib, cap, seg, col0, real_l):
    """Each seg-row segment's cap least keys, built position by position."""
    d2 = _sq(blocks, lib)
    l = lib.shape[0]
    nseg = -(-l // seg)
    bias = P._k11_bias(P._k11_dp(blocks.shape[1]))
    out = np.empty((len(blocks), nseg, cap), np.int64)
    for i in range(len(blocks)):
        for s in range(nseg):
            keys = []
            for p in range(seg):
                j, col = s * seg + p, col0 + s * seg + p
                hi = d2[i, j] - bias if j < l and col < real_l else P.I32_MAX
                keys.append((int(hi) << 32) | col)
            out[i, s] = sorted(keys)[:cap]
    return out


def _jax_argmin(blocks, lib, bc=8):
    b, d = blocks.shape
    bp = -(-b // bc) * bc
    xp = np.pad(blocks, ((0, bp - b), (0, 0)))
    dd, rr = J._l2_argmin_jit(jnp.asarray(xp.reshape(-1)), jnp.asarray(lib.reshape(-1)),
                              d=d, bc=bc, real_l=lib.shape[0])
    return np.asarray(dd)[:b], np.asarray(rr)[:b]


def _jax_prefilter(blocks, lib, kp, bc=8):
    b, d = blocks.shape
    bp = -(-b // bc) * bc
    xp = np.pad(blocks, ((0, bp - b), (0, 0)))
    idx = J._mxu_prefilter_jit(jnp.asarray(xp.reshape(-1)), jnp.asarray(lib.reshape(-1)),
                               d=d, bc=bc, k_pre=kp)
    return np.asarray(idx)[:b]


@pytest.mark.parametrize("d", [12, 48, 192])
@pytest.mark.parametrize("kind", ["uniform", "duplicates"])
def test_l2_argmin_matches_jax(d, kind):
    """`_l2_argmin` (K11's argmin on the card, its plain version here) and
    `_l2_argmin_ref` against `_l2_argmin_jit`: the same rows, the lowest
    among equal distances (duplicated rows tie), the same int32 dist^2."""
    rng = np.random.default_rng(d)
    lib = rng.integers(0, 256, size=(700, d), dtype=np.uint8)
    if kind == "duplicates":
        lib = np.concatenate([lib[:300], lib[:300], lib[:100]])
    blocks = rng.integers(0, 256, size=(37, d), dtype=np.uint8)
    blocks[:5] = lib[[3, 250, 299, 0, 100]]
    jd, jr = _jax_argmin(blocks, lib)
    for fn in (P._l2_argmin, P._l2_argmin_ref):
        dist, row = fn(_t(blocks), _t(lib))
        np.testing.assert_array_equal(row.numpy(), jr)
        np.testing.assert_array_equal(dist.numpy(), jd)
    d2 = _sq(blocks, lib)
    np.testing.assert_array_equal(jr, _least_rows(d2, 1)[:, 0])


@pytest.mark.parametrize("d,l,kp", [(12, 6000, 64), (48, 9000, 64), (192, 5000, 100)])
def test_l2_prefilter_matches_jax(d, l, kp):
    """The two-level prefilter (stage 1 on `l2_topcap` with the plan's
    segment and cap, certified) keeps the JAX prefilter's set on data with
    no tie at the cut, and is the exact k_pre least by (dist^2, row)."""
    rng = np.random.default_rng(d + l)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(24, d), dtype=np.uint8)
    assert _no_tie_at_cut(blocks, lib, kp)
    assert P._k11_topcap_plan(l, kp) is not None
    got = P._l2_prefilter(_t(blocks), _t(lib), kp).numpy()
    want = _jax_prefilter(blocks, lib, kp)
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    np.testing.assert_array_equal(got, _least_rows(_sq(blocks, lib), kp))


@pytest.mark.parametrize("d", [12, 48, 192])
@pytest.mark.parametrize("seg,cap", [(128, 1), (128, 8), (256, 16), (512, 24), (1024, 32)])
def test_l2_topcap_ref_per_segment(d, seg, cap):
    """`_l2_topcap_ref` against the per-segment oracle: a ragged last
    segment, duplicated rows across segments, a col0 offset and real_l
    inside the library."""
    rng = np.random.default_rng(seg + cap + d)
    base = rng.integers(0, 256, size=(700, d), dtype=np.uint8)
    lib = np.concatenate([base, base[:400]])[rng.permutation(1100)]
    blocks = rng.integers(0, 256, size=(6, d), dtype=np.uint8)
    for col0, real_l in ((0, 1100), (500, 1300)):
        got = P.l2_topcap(_t(blocks), _t(lib), cap, seg=seg, col0=col0, real_l=real_l)
        np.testing.assert_array_equal(got.numpy(),
                                      _topcap_oracle(blocks, lib, cap, seg, col0, real_l))


@pytest.mark.parametrize("d", [768, 3072, 49152])
def test_l2_routes_exact_at_wide_rows(d):
    """Past D = 258 the port's order is the exact one: the argmin, stage 1
    and the prefilter against the int64 oracle; past 33024 bytes the
    top-cap's high word is dist^2 - 2^31."""
    rng = np.random.default_rng(d)
    l = 300 if d == 49152 else 5000  # 5000: the prefilter takes the two-level route
    # at D = 49152 bright library rows put an all-zero block's distances past 2^31
    lib = rng.integers(215 if d == 49152 else 0, 256, size=(l, d), dtype=np.uint8)
    lib[7] = lib[200]  # a tie
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    blocks[0] = lib[200]
    blocks[1] = 0
    d2 = _sq(blocks, lib)
    dist, row = P._l2_argmin(_t(blocks), _t(lib))
    np.testing.assert_array_equal(row.numpy(), _least_rows(d2, 1)[:, 0])
    assert row[0] == 7 and dist[0] == 0
    want_d = d2[np.arange(9), row.numpy()]
    np.testing.assert_array_equal(dist.numpy(), want_d.astype(np.uint32).view(np.int32))
    got = P.l2_topcap(_t(blocks), _t(lib), 8, seg=256)
    np.testing.assert_array_equal(got.numpy(), _topcap_oracle(blocks, lib, 8, 256, 0, l))
    if d == 49152:
        assert P._k11_bias(P._k11_dp(d)) == 1 << 31 and (d2[1] >= 1 << 31).all()
        assert int(got[1, 0, 0] >> 32) == int(d2[1, :256].min()) - (1 << 31) > 0
        assert int(got[0, 0, 0] >> 32) == -(1 << 31)  # row 7 at distance 0
    np.testing.assert_array_equal(P._l2_prefilter(_t(blocks), _t(lib), 40).numpy(),
                                  _least_rows(d2, 40))


def test_l2_argmin_wraps_as_int32_past_33025():
    """The winner's dist^2 past 2^31 comes back as its int32 bits, as the
    JAX package's int32 sum and the port's earlier route wrap."""
    d = 40000
    blocks = np.zeros((2, d), np.uint8)
    lib = np.full((3, d), 255, np.uint8)
    lib[1, :5] = 254
    dist, row = P._l2_argmin(_t(blocks), _t(lib))
    want = 255 * 255 * (d - 5) + 254 * 254 * 5
    assert want >= 1 << 31
    np.testing.assert_array_equal(row.numpy(), [1, 1])
    np.testing.assert_array_equal(dist.numpy(), np.array([want] * 2, np.int64).astype(np.int32))


def test_prefilter_certificate_falls_back_exactly(monkeypatch):
    """A cap too small for runs of similar rows (3 a 128-row segment, 20
    rows near each of 10 blocks in one segment): those rows fail the
    certificate and run again with whole 128-row segments, most others
    certify, and every row is the exact k_pre least."""
    rng = np.random.default_rng(5)
    l, d, kp = 4000, 12, 8
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(30, d), dtype=np.uint8)
    near = np.clip(blocks[:10, None].astype(int) + rng.integers(-2, 3, (10, 20, d)), 0, 255)
    for i in range(10):  # 20 near rows in one segment each: 20 > cap
        lib[128 * i : 128 * i + 20] = near[i]
    monkeypatch.setattr(P, "_k11_topcap_plan", lambda l_, k_: (128, 3))
    calls = []
    real = P.l2_topcap
    monkeypatch.setattr(P, "l2_topcap", lambda x, t, cap, **kw: calls.append((len(x), cap))
                        or real(x, t, cap, **kw))
    got = P._l2_prefilter(_t(blocks), _t(lib), kp).numpy()
    np.testing.assert_array_equal(got, _least_rows(_sq(blocks, lib), kp))
    assert calls[0] == (30, 3) and len(calls) == 2
    assert calls[1][1] == 128 and 10 <= calls[1][0] < 30


@pytest.mark.parametrize("l,kp,d,plan", [
    (20000, 1024, 12, (128, 21)),  # the 1/16 bound fails every segment: caps of 21
    (400, 64, 12, (128, 43)),  # caps above 32: whole segments ranked
    (1100, 1024, 48, (128, 128)),  # segments kept whole
])
def test_prefilter_past_every_fast_plan(monkeypatch, l, kp, d, plan):
    """k_pre too large a share of the library for a fast plan: 128-row
    segments, with the cap raised as far as the whole segment, still give
    the exact k_pre least, over library chunks of `_l2_dense`."""
    rng = np.random.default_rng(l)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    lib[l // 2 : l // 2 + 100] = lib[0]
    blocks = rng.integers(0, 256, size=(7, d), dtype=np.uint8)
    assert P._k11_topcap_plan(l, kp) == plan
    monkeypatch.setattr(P, "_BLOCK_F32_BYTES", 4 * d * 333)
    np.testing.assert_array_equal(P._l2_prefilter(_t(blocks), _t(lib), kp).numpy(),
                                  _least_rows(_sq(blocks, lib), kp))


@pytest.mark.parametrize("kw,err", [
    (dict(cap=0), ValueError), (dict(cap=129), ValueError), (dict(cap=8, seg=100), ValueError),
    (dict(cap=8, col0=2**31 - 100), ValueError),
])
def test_l2_topcap_refuses_what_k11_does_not_take(kw, err):
    x = torch.zeros((3, 12), dtype=torch.uint8)
    t = torch.zeros((300, 12), dtype=torch.uint8)
    cap = kw.pop("cap")
    with pytest.raises(err):
        P.l2_topcap(x, t, cap, **kw)


def test_l2_entries_refuse_rows_past_66051_bytes_and_other_types():
    x = torch.zeros((2, 66052), dtype=torch.uint8)
    with pytest.raises(ValueError):
        P._l2_argmin(x, x)
    with pytest.raises(TypeError):
        P._l2_argmin(x[:, :12].int(), x[:, :12].int())
