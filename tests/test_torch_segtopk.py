"""Port parity: the segment top-cap (kernel K4's plain version) and the
coarse pass built on it, against the JAX package and the TPU lab kernel.

`seg_topk` is held against the Pallas kernel `_seg8_kernel` of
`tools/tpu_r14_seg8.py` (`seg_topk_pallas`, run through the Pallas
interpreter, the module loaded by its path) and against
`jax.lax.top_k(-seg, cap)`, exactly, with the tool's own tie and padding
cases. `_ad_coarse` (whose selection is `coarse_topcap`, kernel K9's
plain version `_coarse_topcap_ref` on the CPU) is held against
`_ad_coarse_jit` at caps 1, 8 and 16, every group width and one segment.
K4 and K9 themselves run only on a GPU: `tests/test_torch_gpu.py` holds
them against `_seg_topcap_ref` and `_coarse_topcap_ref`.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as jax_distance
from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import COARSE_TOPCAP, SEG_TOPCAP

ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=1)
def _seg8_tool():
    spec = importlib.util.spec_from_file_location(
        "tpu_r14_seg8", ROOT / "tools" / "tpu_r14_seg8.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tool_case(seed=0, bc=32, nseg=130):
    """The tool's interpret-mode case (tools/tpu_r14_seg8.py:110-124): a
    full-tie segment, a padded-column lookalike, nseg off the 128 grid."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 50, size=(bc, nseg, 128)).astype(np.int32)
    seg[0, 0, :] = 7
    seg[1, 3, 10:] = distance._TL_BIG
    return seg


@pytest.mark.parametrize("cap", [8, 16])
def test_seg_topk_matches_the_pallas_tool_and_lax_top_k(cap):
    seg = _tool_case()
    vals, idx = distance.seg_topk(_t(seg), cap)
    assert vals.dtype == idx.dtype == torch.int32
    assert tuple(vals.shape) == (32, 130, cap)
    tool = _seg8_tool()
    pv, pi = jax.jit(functools.partial(tool.seg_topk_pallas, cap=cap, interpret=True))(
        jnp.asarray(seg)
    )
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    nd, ni = jax.lax.top_k(-jnp.asarray(seg), cap)
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(nd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ni))
    # the full-tie segment keeps its lowest lanes, in order
    np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(cap))
    assert (vals[0, 0] == 7).all()


@pytest.mark.parametrize("nseg,cap", [(1, 8), (7, 16), (128, 8)])
def test_seg_topk_matches_lax_top_k_at_other_widths(nseg, cap):
    rng = np.random.default_rng(nseg)
    seg = rng.integers(0, 2**30, size=(5, nseg, 128)).astype(np.int32)
    seg[:, :, ::3] = seg[:, :, :1]  # repeated values across lanes
    vals, idx = distance.seg_topk(_t(seg), cap)
    nd, ni = jax.lax.top_k(-jnp.asarray(seg), cap)
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(nd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ni))


def test_seg_topcap_masks_padding_columns_and_keeps_row_order():
    """Positions whose col is >= real_l count as _TL_BIG; the keys carry
    the col, ascending by (value, col) within each segment."""
    rng = np.random.default_rng(3)
    nseg, r, cap, real_l = 3, 4, 8, 300
    lp = nseg * 128
    pos = np.arange(lp)
    cols = (pos % 128) * nseg + pos // 128  # the coarse pass's layout
    dist = rng.integers(0, 20, size=(r, lp)).astype(np.int32)
    keys = distance.seg_topcap(_t(dist), _t(cols), cap, real_l).numpy()
    assert keys.shape == (r, nseg * cap)
    masked = np.where(cols >= real_l, distance._TL_BIG, dist).astype(np.int64)
    want = (masked << 32) | cols
    want = np.sort(want.reshape(r, nseg, 128), axis=2)[:, :, :cap].reshape(r, -1)
    np.testing.assert_array_equal(keys, want)


def test_seg_topcap_checks_its_inputs_and_does_not_launch_on_the_cpu():
    d = torch.zeros((2, 256), dtype=torch.int32)
    c = torch.arange(256)
    SEG_TOPCAP.launches = 0
    distance.seg_topcap(d, c, 16, 256)
    assert SEG_TOPCAP.launches == 0
    with pytest.raises(ValueError, match="cap"):
        distance.seg_topcap(d, c, 129, 256)
    with pytest.raises(ValueError, match="cap"):
        distance.seg_topcap(d, c, 0, 256)
    with pytest.raises(ValueError, match="int32"):
        distance.seg_topcap(d[:, :200], c[:200], 8, 256)
    with pytest.raises(ValueError, match="int32"):
        distance.seg_topcap(d.to(torch.int64), c, 8, 256)
    with pytest.raises(ValueError, match="cols"):
        distance.seg_topcap(d, c[:128], 8, 256)
    with pytest.raises(ValueError, match="wide"):
        distance.seg_topk(torch.zeros((1, 2, 64), dtype=torch.int32), 8)


@pytest.mark.parametrize("cap", [1, 8, 16])
@pytest.mark.parametrize(
    "d,g,chan,kind,l",
    [(48, 4, True, "clustered", 2500),    # g = 4 by hand (the plan takes 8)
     (96, 8, True, "dupes", 2500),        # g = 8 by hand (the plan takes 16)
     (128, 4, False, "random", 2500),     # g = 4 by hand (the plan takes 32)
     (48, 8, True, "random", 2500),       # mode 4: dout 6
     (48, 8, True, "dupes", 100),         # L <= 128: one segment
     (108, 4, True, "clustered", 2500),   # mode 6: dout 27
     (768, 32, True, "dupes", 1000),      # mode 16: dout 24
     (80, 16, False, "random", 700),      # g = 16: dout 5
     (12288, 32, True, "clustered", 300)],  # mode 64: dout 384
)
def test_ad_coarse_keys_and_s_min_match_jax(rng, cap, d, g, chan, kind, l):
    """The coarse pass's survivor keys and s_min, bit for bit, against
    `_ad_coarse_jit`, with a ragged last segment (L not a multiple of 128),
    at every group width of `_AD_GROUPS`, one segment, and exact duplicate
    rows in other segments ("dupes": row i and row i + L/2)."""
    b = 16
    lp = -(-l // 128) * 128
    if (d, g) not in ((48, 4), (96, 8), (128, 4)):  # else the plan's own choice
        assert distance._ad_plan(b, l, d, 1)[1:3] == (g, chan)
    if kind == "clustered":
        bases = rng.integers(0, 256, size=(25, 1, d))
        lib = np.clip(np.repeat(bases, -(-l // 25), axis=0)[:l, 0]
                      + rng.integers(-4, 5, (l, d)), 0, 255)
    else:
        lib = rng.integers(0, 256, size=(l, d))
    lib = lib.astype(np.uint8)
    if kind == "dupes":
        lib[l // 2 :] = lib[: l - l // 2]  # cross-segment exact ties
    blocks = lib[rng.integers(0, l, size=b)]
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    vals, cols, s_min = jax_distance._ad_coarse_jit(
        jnp.asarray(blocks.reshape(-1)), jnp.asarray(lib_pad.reshape(-1)),
        d=d, g=g, chan=chan, bc=8, cap=cap, real_l=l,
    )
    coarse_lib = distance._ad_coarse_lib(_t(lib_pad), d, g, chan, l)
    keys, sm = distance._ad_coarse(_t(blocks), coarse_lib, d, g, chan, cap)
    np.testing.assert_array_equal((keys >> 32).numpy(), np.asarray(vals))
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), np.asarray(cols))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(s_min))


def test_coarse_library_layout_and_plain_k9():
    """`_ad_coarse_lib` lays the projection out as K9 reads it ([nseg, dout,
    128] f32, proj[s, c, k] = coordinate c of row k*nseg + s), and K9's
    plain version is `l1_block` then `_seg_topcap_ref` on those rows."""
    rng = np.random.default_rng(9)
    d, g, l = 48, 8, 300
    lp = 384
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = rng.integers(0, 256, size=(l, d))
    proj, cols, real_l = distance._ad_coarse_lib(_t(lib_pad), d, g, True, l)
    want = distance._ad_project(_t(lib_pad), d, g, True)
    assert proj.dtype == torch.float32 and tuple(proj.shape) == (3, 6, 128)
    for s, c, k in [(0, 0, 0), (2, 5, 127), (1, 3, 64)]:
        assert proj[s, c, k] == want[k * 3 + s, c]
    np.testing.assert_array_equal(distance._ad_rows(proj).numpy(), want[cols.long()].numpy())
    xp = distance._ad_project(_t(lib_pad[:5]), d, g, True)
    keys = torch.empty((5, 3 * 4), dtype=torch.int64)
    s_min = torch.empty((5,), dtype=torch.int32)
    COARSE_TOPCAP.launches = 0
    distance.coarse_topcap(xp, (proj, cols, real_l), 4, keys, s_min)
    assert COARSE_TOPCAP.launches == 0
    wk, ws = distance._coarse_topcap_ref(xp, proj, cols, 4, real_l)
    ref = distance._seg_topcap_ref(distance.l1_block(xp, want[cols.long()]), cols, 4, real_l)
    assert torch.equal(keys, wk) and torch.equal(wk, ref) and torch.equal(s_min, ws)
    with pytest.raises(ValueError, match="cap"):
        distance.coarse_topcap(xp, (proj, cols, real_l), 129, keys, s_min)
    with pytest.raises(ValueError, match="keys"):
        distance.coarse_topcap(xp, (proj, cols, real_l), 8, keys, s_min)
    with pytest.raises(ValueError, match="projected rows"):
        distance.coarse_topcap(xp.float(), (proj, cols, real_l), 4, keys, s_min)
