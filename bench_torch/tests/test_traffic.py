"""The one generator and its kinds: a seed gives the same scene, two seeds
two scenes, every seed the same sizes and the same photos' content in
another order."""

import base64
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_torch import scene, spec
from bench_torch.reference import blocks_of

TRAFFIC = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))
CFG = {"mode": 4, "tile_size": 8, "tiles": 64, "source_height": 48, "source_width": 80}


def _mix(traffic):
    return json.loads((spec.HERE / "traffic" / f"{traffic}.json").read_text())


def _scene(traffic, seed, cfg=CFG):
    return scene.make_scene(cfg, _mix(traffic), seed, "cpu")


def _same(a, b):
    return (torch.equal(a.palettes, b.palettes) and torch.equal(a.stack, b.stack)
            and all(np.array_equal(x, y) for x, y in zip(a.sources, b.sources)))


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_one_seed_one_scene(traffic):
    assert _same(_scene(traffic, 2**31 + 17), _scene(traffic, 2**31 + 17))


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_two_seeds_two_scenes_of_one_size(traffic):
    a, b = _scene(traffic, 3), _scene(traffic, 4)
    assert not _same(a, b)
    assert a.palettes.shape == b.palettes.shape == (64, 16, 3)
    assert a.stack.shape == (64, 8, 8, 3)
    assert len(a.sources) == len(b.sources) == 8
    assert {s.shape for s in a.sources + b.sources} == {(48, 80, 3)}
    assert {s.dtype for s in a.sources} == {np.dtype(np.uint8)}


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_the_pool_holds_distinct_photos(traffic):
    src = _scene(traffic, 9).sources
    assert not any(np.array_equal(src[0], s) for s in src[1:])


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_every_seed_renders_the_same_eight_views(traffic):
    """The pool's photos are the image's 8 flips and quarter turns, each
    once, in an order drawn from the seed: the seed changes the order and
    the crops, not the work."""
    mix = _mix(traffic)
    if mix["sources"]["kind"] != "sample_image":
        pytest.skip("not made from an image")
    kind = spec.load_module("traffic", "sample_image")
    base = kind.image(mix["sources"]["image"], SimpleNamespace(base=spec.HERE, dev="cpu"))
    views = {kind.dihedral(base, t).numpy().tobytes() for t in range(8)}
    assert len(views) == 8
    cfg = dict(CFG, source_height=96 * 4, source_width=128 * 4)
    for seed in (1, 2**31 + 3):
        got = _scene(traffic, seed, cfg).sources
        # each photo is a crop of one view enlarged, a different view each
        seen = set()
        for photo in got:
            assert photo.shape == (384, 512, 3)
            for t in range(8):
                big = kind.enlarge(kind.dihedral(base, t), 384, 512).numpy()
                if any(np.array_equal(big[oy : oy + 384, ox : ox + 512], photo)
                       for oy in range(big.shape[0] - 383)
                       for ox in range(big.shape[1] - 511)):
                    seen.add(t)
                    break
        assert seen == set(range(8))


def test_the_image_is_the_repositorys_example():
    from PIL import Image

    png = spec.ROOT / "example" / "sample.png"
    want = np.asarray(Image.open(png).convert("RGB"))
    raw = spec.load_json(spec.HERE / "images" / "sample.json")
    got = np.frombuffer(base64.b64decode(raw["rgb_base64"]), np.uint8)
    assert np.array_equal(got.reshape(raw["height"], raw["width"], 3), want)


@pytest.mark.parametrize("dim,h,w", [(4, 256, 320), (32, 1024, 1024)])
def test_photo_blocks_are_nearly_all_distinct(dim, h, w):
    cfg = dict(CFG, mode=dim, tile_size=dim, source_height=h, source_width=w)
    for p in _scene("photo_on_tiles", 5, cfg).sources:
        xp = blocks_of(torch.from_numpy(p), dim)
        assert len(torch.unique(xp, dim=0)) > 0.75 * xp.shape[0]


def test_tile_palettes_are_the_box_means_of_the_tiles():
    tiles = torch.randint(0, 256, (5, 8, 8, 3), dtype=torch.uint8)
    want = tiles.reshape(5, 4, 2, 4, 2, 3).int().sum((2, 4)) // 4
    assert torch.equal(scene.box_mean(tiles, 4), want.to(torch.uint8).reshape(5, 16, 3))


def test_sizes_of_the_configurations():
    for name, want in (("generate_m32", (16384, 65534, 3072, 4096 ** 2)),
                       ("cli_m4", (262144, 65534, 48, 8192 ** 2))):
        sz = scene.sizes(json.loads((spec.HERE / "configs" / f"{name}.json").read_text()))
        assert (sz["B"], sz["L"], sz["D"], sz["out_pixels"]) == want


def test_sizes_of_a_photo_that_is_not_square():
    sz = scene.sizes(dict(CFG, mode=32, tile_size=16, source_height=2914, source_width=8192))
    assert (sz["gh"], sz["gw"], sz["B"]) == (91, 256, 91 * 256)
    assert sz["out_pixels"] == 91 * 16 * 256 * 16
