"""Port parity: the no-repeat renderers and the randomized render against
the JAX package, in memory (`TileSet.from_arrays`), on the CPU.

`render_nto1_no_repeat` runs through both scoring routes (the dense
`exact-full` and the certified `adaptive-exact`) and both assignment
engines (native and pure Python); `render_nto1` with `no_repeat=True`
(the in-render `--greedy` variant) and with `randomize`. Items, the
composite and the stats image must equal the JAX package's exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from emosaic_tpu.render import matched as jax_matched
from emosaic_tpu.render import norepeat as jax_norepeat
from emosaic_tpu.tiles.tileset import TileSet as JaxTileSet
from emosaic_tpu_torch import native
from emosaic_tpu_torch.ops import distance, refill
from emosaic_tpu_torch.parallel import make_mesh
from emosaic_tpu_torch.render import matched, norepeat
from emosaic_tpu_torch.tiles.tileset import TileSet

quiet = dict(log=lambda *a: None)


def _sets(pal):
    paths = [f"tiles/t{i}.jpg" for i in range(len(pal))]
    return TileSet.from_arrays(pal, paths), JaxTileSet(
        palettes=pal, paths=[Path(p) for p in paths]
    )


def _clustered_scene(rng, t, dim, h, w):
    """Tiles in runs of similar colours and a source made of them plus
    noise: the data the adaptive scorer certifies on."""
    n = dim * dim
    bases = rng.integers(0, 256, size=(-(-t // 8), 1, 3))
    pal = np.clip(
        np.repeat(bases, 8, axis=0)[:t] + rng.integers(-10, 11, size=(t, n, 3)), 0, 255
    ).astype(np.uint8)
    src = np.clip(
        rng.integers(0, 256, size=(h // dim, w // dim, 1, 1, 3)).repeat(dim, 2).repeat(dim, 3)
        .transpose(0, 2, 1, 3, 4).reshape(h, w, 3) + rng.integers(-6, 7, size=(h, w, 3)),
        0, 255,
    ).astype(np.uint8)
    return pal, src


def _same(got, want, ts=8):
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(np.asarray(got.image), np.asarray(want.image))
    np.testing.assert_array_equal(got.stats.render(ts), want.stats.render(ts))


#: the stage spans of every no-repeat render, and the adaptive scorer's steps
_NO_REPEAT_STAGES = ("render", "render.prologue", "prologue.library", "norepeat.scoring",
                     "norepeat.to_host", "norepeat.engine", "render.stats", "render.compose",
                     "compose.stack")
_SCORING_STEPS = ("prepare", "coarse", "rescore", "fallback", "audit")


@pytest.mark.parametrize("route", ["exact-full", "exact-full-u64", "adaptive-exact"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_render_nto1_no_repeat_matches_jax(rng, monkeypatch, route, engine):
    """Routes as `info["scorer"]` names them, and "exact-full-u64": the
    sort's plan forced to 8-byte keys, so the native engine takes the
    (distance, row) pair where it reads the u32 keys otherwise."""
    # 192 blocks, L = 8400 rows of D = 48: past the adaptive scorer's gates
    # (L > 2m and 128-row segments x cap >= m + 1 at m = 1024)
    pal, src = _clustered_scene(rng, 4200, 4, 48, 64)
    stack = rng.integers(0, 256, size=(4200, 8, 8, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 8, stack=stack, **quiet)
    if route == "adaptive-exact":
        monkeypatch.setattr(norepeat, "_EXACT_BUDGET", 0)
    if route == "exact-full-u64":
        plan = distance._k13_plan
        monkeypatch.setattr(distance, "_k13_plan", lambda n, dmax: (8, *plan(n, dmax)[1:]))
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    got = norepeat.render_nto1_no_repeat(src, ts, 8, device="cpu", stack=stack, **quiet)
    assert got.info["scorer"] == route.removesuffix("-u64") and got.info["engine"] == engine
    if route != "adaptive-exact":
        packed = route == "exact-full" and engine == "native"
        assert got.info["scoring"]["key_bytes"] == (4 if route == "exact-full" else 8)
        assert got.info["scoring"]["lists"] == ("packed" if packed else "pair")
    spans = got.info["spans"]
    assert set(_NO_REPEAT_STAGES) <= set(spans)
    assert got.info["scoring_s"] == spans["norepeat.scoring"]["s"]
    assert got.info["assign_s"] == pytest.approx(
        spans["norepeat.to_host"]["s"] + spans["norepeat.engine"]["s"])
    if route == "adaptive-exact":
        assert got.info["scoring"]["route"] == "adaptive"
        assert {f"scoring.{step}" for step in _SCORING_STEPS} <= set(spans)
        assert not {f"{step}_s" for step in _SCORING_STEPS} & set(got.info["scoring"])
    _same(got, want)
    items = got.items.reshape(-1)
    assert len(set(np.abs(items).tolist())) == items.size  # mirror-pair exclusion


def test_no_repeat_device_refill_route_bit_identical(rng, monkeypatch):
    """With the threshold at 0 (`refill._DEVICE_REFILL_MIN_LD`) refills go
    through DeviceRefiller; with B near T the prefixes run dry, so refills
    really happen."""
    pal, src = _clustered_scene(rng, 200, 2, 24, 24)  # 144 blocks, T = 200
    stack = rng.integers(0, 256, size=(200, 4, 4, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 4, stack=stack, **quiet)
    monkeypatch.setattr(norepeat, "_EXACT_BUDGET", 0)
    monkeypatch.setattr(norepeat, "_TRUNCATED_K", 4)
    monkeypatch.setattr(refill, "_DEVICE_REFILL_MIN_LD", 0)
    got = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", stack=stack, **quiet)
    if native.available():
        assert got.info["refill_events"] > 0
    _same(got, want, 4)


@pytest.mark.parametrize(
    "engine,route", [("native", "0"), ("native", None), ("python", None), ("native", "oversized")]
)
def test_no_repeat_refill_counters(rng, monkeypatch, engine, route):
    """Device refills count their calls, blocks and rows, and the calls K12
    served, and are spans; the engine's host scans count their events and
    seconds; the render is the JAX package's either way. Routes, with the
    device refill's threshold at 0: the default (every device call on
    K12), "0" (`_K12_MAX_M` = 0: every call on K10's stripe), "oversized"
    (a library past the device budget: `refiller_for` gives no refiller,
    every event on the host scan)."""
    pal, src = _clustered_scene(rng, 200, 2, 24, 24)  # 144 blocks, T = 200
    stack = rng.integers(0, 256, size=(200, 4, 4, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 4, stack=stack, **quiet)
    monkeypatch.setattr(norepeat, "_EXACT_BUDGET", 0)
    # lists of 12: about ten refill events of 1 to 5 blocks (of 4, one of
    # 119 blocks)
    monkeypatch.setattr(norepeat, "_TRUNCATED_K", 12)
    monkeypatch.setattr(refill, "_DEVICE_REFILL_MIN_LD", 0)
    if route == "0":
        monkeypatch.setattr(refill, "_K12_MAX_M", 0)
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host C++ compiler could not build the native engine")
    if route == "oversized":  # 400 library rows of 12 bytes, one byte past the budget
        monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", 400 * 12 - 1)
    got = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", stack=stack, **quiet)
    info, spans = got.info, got.info["spans"]
    assert set(_NO_REPEAT_STAGES) <= set(spans)
    if engine == "native" and route != "oversized":
        assert info["refill_blocks"] >= info["refill_events"] > 0
        assert info["refill_host_events"] == 0
        assert info["refill_events"] > 1
        assert info["refill_fused_events"] == (0 if route == "0" else info["refill_events"])
        assert spans["norepeat.refill"]["n"] == info["refill_events"]
        # the refills are the engine's children
        assert spans["norepeat.engine"]["self_s"] == pytest.approx(
            spans["norepeat.engine"]["s"] - spans["norepeat.refill"]["s"])
    else:
        assert info["refill_host_events"] > 0 and info["refill_host_s"] > 0
        assert info.get("refill_events", 0) == 0 and "norepeat.refill" not in spans
        if engine == "native":  # the rule left the engine without a refiller
            assert info["refill_events"] == info["refill_fused_events"] == 0
    _same(got, want, 4)


def test_no_repeat_streamed_scorer_end_to_end(rng, monkeypatch):
    src = rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
    pal = rng.integers(0, 256, size=(300, 1, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(300, 4, 4, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 4, stack=stack, **quiet)
    monkeypatch.setattr(norepeat, "_EXACT_BUDGET", 0)
    monkeypatch.setattr(distance, "DEVICE_LIB_BYTES_MAX", 128 * 3)
    calls = []
    real = distance.l1_topk_streamed
    monkeypatch.setattr(distance, "l1_topk_streamed", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", stack=stack, **quiet)
    assert calls
    _same(got, want, 4)


def test_no_repeat_starved_blocks_render_black(rng):
    src = rng.integers(0, 256, size=(1, 5, 3), dtype=np.uint8)  # B = 5
    pal = rng.integers(0, 256, size=(3, 1, 3), dtype=np.uint8)  # T = 3
    stack = rng.integers(1, 256, size=(3, 4, 4, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    got = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", stack=stack, **quiet)
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 4, stack=stack, **quiet)
    assert (got.items == 0).sum() == 2
    _same(got, want, 4)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_greedy_no_repeat_matches_jax(rng, monkeypatch, engine):
    pal, src = _clustered_scene(rng, 90, 2, 16, 20)  # 80 blocks, T = 90
    stack = rng.integers(1, 256, size=(90, 8, 8, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_matched.render_nto1(src, jts, 8, no_repeat=True, stack=stack, seed=5, **quiet)
    if engine == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    got = matched.render_nto1(src, ts, 8, no_repeat=True, stack=stack, seed=5,
                              device="cpu", **quiet)
    _same(got, want)
    assert len(set(got.items.reshape(-1).tolist())) == got.items.size


@pytest.mark.parametrize("randomize,seed", [(10.0, 3), (50.0, 0), (0.0, 7)])
def test_randomize_matches_jax(rng, randomize, seed):
    pal = rng.integers(0, 256, size=(40, 4, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(40, 8, 8, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    want = jax_matched.render_nto1(src, jts, 8, randomize=randomize, seed=seed, stack=stack, **quiet)
    got = matched.render_nto1(src, ts, 8, randomize=randomize, seed=seed, stack=stack,
                              device="cpu", **quiet)
    _same(got, want)


def test_no_repeat_refusals(rng):
    pal = np.zeros((2, 1, 3), np.uint8)
    ts, _ = _sets(pal)
    src = np.zeros((4, 4, 3), np.uint8)  # 16 blocks > 2 * 2 tiles
    with pytest.raises(ValueError, match="Insufficient tiles"):
        matched.render_nto1(src, ts, 4, no_repeat=True, device="cpu", **quiet)
    with pytest.raises(ValueError, match="Insufficient tiles"):
        norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", **quiet)
    with pytest.raises(ValueError, match="deadlocks"):
        matched.render_nto1(src, ts, 4, no_repeat=True, randomize=5.0, device="cpu")
    with pytest.raises(ValueError, match="scorer"):
        norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", scorer="fastest")
    with pytest.raises(ValueError, match="Insufficient tiles"):
        norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", scorer="hybrid")
    # a mesh is no refusal: it gives the single-device item grid
    pal = rng.integers(0, 256, size=(60, 1, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    src = rng.integers(0, 256, size=(6, 10, 3), dtype=np.uint8)  # 60 blocks
    mesh = make_mesh(8, model=2, devices=[torch.device("cpu")] * 8)
    got = norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", mesh=mesh, compose=False,
                                         **quiet)
    assert got.info["scorer"] == "sharded-exact"
    want = jax_norepeat.render_nto1_no_repeat(src, jts, 4, compose=False, **quiet)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(
        got.items,
        norepeat.render_nto1_no_repeat(src, ts, 4, device="cpu", compose=False, **quiet).items,
    )


def test_matcher_knob_ignored_warning_matches_jax(rng):
    pal = rng.integers(0, 256, size=(40, 1, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(4, 6, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(40, 4, 4, 3), dtype=np.uint8)
    ts, jts = _sets(pal)
    msgs, jmsgs = [], []
    matched.render_nto1(src, ts, 4, randomize=10.0, use_lut="never", stack=stack,
                        device="cpu", log=msgs.append)
    jax_matched.render_nto1(src, jts, 4, randomize=10.0, use_lut="never", stack=stack,
                            log=jmsgs.append)
    assert [m for m in msgs if "ignored" in m] == [m for m in jmsgs if "ignored" in m]
    assert any("ignored" in m for m in msgs)
