"""`ops/copies.py`, the route of a device-to-host copy: the arrays it hands
on, the size rule that sends a copy to page-locked memory, the counters
it adds to a render's record, and the call sites that go through it.

On the CPU the page-locked route runs with plain memory in place of the
cache's blocks (`landed`), so its copies, views and counters are checked
here; the tests marked `cuda` hold the real route on the card to the
plain one. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_copies.py -q
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch import monitor
from emosaic_tpu_torch.ops import composite, copies, distance
from emosaic_tpu_torch.render import matched, norepeat
from emosaic_tpu_torch.tiles.tileset import TileSet

BIG = copies.PINNED_MIN_BYTES
quiet = dict(log=lambda *a: None)


@pytest.fixture
def landed(monkeypatch):
    """Every copy takes the page-locked route, into plain memory standing
    in for the cache's blocks, each a new allocation; returns the
    (shape, dtype) of each block asked for."""
    asked = []
    empty = torch.empty

    def fake_empty(*shape, pin_memory=False, **kw):
        if pin_memory:
            asked.append((tuple(shape[0]), kw["dtype"]))
        return empty(*shape, **kw)

    monkeypatch.setattr(copies, "_page_locked", lambda device, nbytes: True)
    monkeypatch.setattr(copies.torch, "empty", fake_empty)
    monkeypatch.setattr(copies, "_host_allocs", lambda: len(asked))
    return asked


def _tensors():
    """(name, tensor): each dtype the call sites copy, a 0-size one and
    non-contiguous views."""
    g = torch.Generator().manual_seed(22)
    i32 = torch.randint(-(2**31), 2**31 - 1, (37, 53), dtype=torch.int32, generator=g)
    u8 = torch.randint(0, 256, (41, 3072), dtype=torch.uint8, generator=g)
    return [
        ("u8", u8),
        ("i32", i32),
        ("i64", i32.to(torch.int64) << 20),
        ("bool", i32 > 0),
        ("f32", torch.rand(17, 5, generator=g)),
        ("empty", torch.empty((0, 64), dtype=torch.int32)),
        ("transposed", i32.t()),
        ("strided", u8[::3, 5:1000:7]),
        ("image", torch.randint(0, 256, (24, 96), dtype=torch.uint8, generator=g)),
    ]


TENSORS = dict(_tensors())


@pytest.mark.parametrize("route", ["plain", "landed"])
@pytest.mark.parametrize("name", sorted(TENSORS))
def test_to_host_is_byte_equal_to_cpu_numpy(request, route, name):
    if route == "landed":
        request.getfixturevalue("landed")
    x = TENSORS[name]
    got, want = copies.to_host(x), x.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if route == "landed":
        assert got.flags.c_contiguous and got.flags.writeable
    if name == "image":
        # the reshape compose_mosaic makes of it
        assert np.array_equal(got.reshape(24, 32, 3), want.reshape(24, 32, 3))


@pytest.mark.parametrize("route", ["plain", "landed"])
def test_the_u32_view_sorted_lists_takes(request, route):
    if route == "landed":
        request.getfixturevalue("landed")
    keys = torch.tensor([[-1, 0, 2**31 - 1, -(2**31)]], dtype=torch.int32)
    got = copies.to_host(keys).view(np.uint32)
    assert got.tolist() == [[2**32 - 1, 0, 2**31 - 1, 2**31]]


@pytest.mark.parametrize("how", ["to_host", "assembly"])
def test_cpu_tensors_never_ask_for_page_locked_memory(monkeypatch, how):
    """Past the size rule, on the CPU: on a CPU-only torch a page-locked
    request raises, and here it is refused besides."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor asked for page-locked memory")

    monkeypatch.setattr(copies, "_pinned_empty", refuse)
    x = torch.arange(2 * BIG // 4, dtype=torch.int32).reshape(-1, 1024)
    if how == "to_host":
        out = copies.to_host(x)
        assert np.shares_memory(out, x.numpy())  # a view, as `.cpu().numpy()` gives
    else:
        host = copies.Assembly(x.device)
        out = host.empty(tuple(x.shape), x.dtype)
        host.put(out[:5], x[:5])
        host.put(out[5:], x[5:])
        host.wait()
        out = out.numpy()
    assert np.array_equal(out, x.numpy())


@pytest.mark.parametrize(
    "device,nbytes,pinned",
    [("cuda", 0, False), ("cuda", 1, False), ("cuda", BIG - 1, False), ("cuda", BIG, True),
     ("cuda", 134217728, True), ("cuda:1", 251658240, True), ("cpu", 0, False),
     ("cpu", BIG, False), ("cpu", 251658240, False)],
)
def test_the_size_rule(device, nbytes, pinned):
    """Copies under the crossover, and every CPU tensor, take the plain path."""
    assert copies._page_locked(torch.device(device), nbytes) is pinned


def test_the_counters_add_the_copied_bytes(landed):
    x = torch.zeros((100, 30), dtype=torch.int32)
    info = {}
    with monitor.record(info):
        copies.to_host(x)
        copies.to_host(x[:, :7])
        host = copies.Assembly(x.device)
        out = host.empty((100,), torch.bool)
        host.put(out[:60], x[:60, 0] > 0)
        host.put(out[60:], x[60:, 0] > 0)
        host.wait()
    assert info["d2h_bytes"] == info["d2h_pinned_bytes"] == 4 * 3000 + 4 * 700 + 100
    assert info["host_pin_allocs"] == len(landed) == 3
    assert landed[-1] == ((100,), torch.bool)
    copies.to_host(x)  # with no record open, nothing is counted
    assert info["d2h_bytes"] == 4 * 3000 + 4 * 700 + 100


def test_a_cpu_copy_counts_nothing():
    info = {}
    with monitor.record(info):
        copies.to_host(torch.zeros(10))
        host = copies.Assembly("cpu")
        out = host.empty((10,), torch.float32)
        host.put(out, torch.ones(10))
        host.wait()
    assert not {"d2h_bytes", "d2h_pinned_bytes", "host_pin_allocs"} & set(info)


@pytest.mark.parametrize("shape,dmax", [((13, 40), 255 * 12), ((7, 300), 2**25)])
def test_unpack_lists_decodes_the_same_lists(request, shape, dmax):
    """u32 keys (the exact-full cell's) and u64 lists, on both routes."""
    g = torch.Generator().manual_seed(shape[1])
    dist = torch.randint(0, dmax + 1, shape, dtype=torch.int32, generator=g)
    dist[:, ::5] = dist[:, :1]  # ties, broken by the row
    plain = distance.unpack_lists(*distance.sorted_lists(dist, dmax))
    request.getfixturevalue("landed")
    lists, bits_c = distance.sorted_lists(dist, dmax)
    assert (bits_c is None) == (dmax == 2**25)
    got = distance.unpack_lists(lists, bits_c)
    order = np.argsort(dist.numpy(), axis=1, kind="stable")
    for g_, p_, w_ in zip(got, plain, (np.take_along_axis(dist.numpy(), order, 1), order)):
        np.testing.assert_array_equal(g_, p_)
        np.testing.assert_array_equal(g_, w_)


def _slices_scorers():
    """(name, fn(blocks, lib)) of the scorers that assemble host arrays from
    device slices."""
    return {
        "stripes": lambda x, t: distance.l1_topk_stripes(x, t, 9, device="cpu"),
        "twolevel": lambda x, t: distance.l1_topk_twolevel(x, t, 9, device="cpu"),
        "adaptive": lambda x, t: distance.l1_topk_adaptive(x, t, 9, device="cpu"),
        "matrix": lambda x, t: (distance.l1_dist_matrix(x, t, device="cpu"),),
    }


@pytest.mark.parametrize("name", sorted(_slices_scorers()))
def test_sliced_scorers_land_each_slice_in_its_place(request, monkeypatch, name):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, size=(300, 48), dtype=np.uint8)
    t = rng.integers(0, 256, size=(700, 48), dtype=np.uint8)
    fn = _slices_scorers()[name]
    monkeypatch.setattr(distance, "_stripe_rows", lambda l, *a: 64)  # several slices
    want = fn(x, t)
    request.getfixturevalue("landed")
    info = {}
    with monitor.record(info):
        got = fn(x, t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert info["d2h_bytes"] == info["d2h_pinned_bytes"] >= sum(w.nbytes for w in want[:2])


def _scene(seed, t=64, dim=4, side=8, ts=8):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 256, size=(t, 1, 3))
    pal = np.clip(bases + rng.integers(-10, 11, size=(t, dim * dim, 3)), 0, 255).astype(np.uint8)
    src = rng.integers(0, 256, size=(side * dim, side * dim, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    tiles = TileSet.from_arrays(pal, [f"tiles/t{i}.jpg" for i in range(t)])
    return src, tiles, ts, stack


RENDERS = {
    "exact_full": lambda src, tiles, ts, stack, device: norepeat.render_nto1_no_repeat(
        src, tiles, ts, device=device, stack=stack, **quiet),
    "sequence": lambda src, tiles, ts, stack, device: matched.render_nto1(
        src, tiles, ts, device=device, stack=stack, no_repeat=True, seed=0, **quiet),
    "repeat": lambda src, tiles, ts, stack, device: matched.render_nto1(
        src, tiles, ts, device=device, stack=stack, **quiet),
}


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_renders_give_the_same_outputs_on_the_landed_route(request, render):
    scene = _scene(3)
    want = RENDERS[render](*scene, "cpu")
    request.getfixturevalue("landed")
    got = RENDERS[render](*scene, "cpu")
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.image, want.image)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked memory is allocated by CUDA")
    return torch.device("cuda", 0)


@pytest.fixture
def plain_route(monkeypatch):
    """The parent's copies: `.cpu().numpy()` at every size."""
    def use():
        monkeypatch.setattr(copies, "PINNED_MIN_BYTES", 2**62)
    return use


def _card_scene(seed):
    """256 blocks and 256 tiles of 768 bytes, and an image of 16 * 64 = 1024
    pixels square: 3 MB, past the size rule."""
    return _scene(seed, t=256, dim=16, side=16, ts=64)


@pytest.mark.cuda
@pytest.mark.parametrize("render", sorted(RENDERS))
def test_card_renders_are_byte_equal_to_the_plain_route(cuda, plain_route, render):
    scene = _card_scene(5)
    got = RENDERS[render](*scene, "cuda")
    assert got.info["d2h_pinned_bytes"] >= got.image.nbytes
    plain_route()
    want = RENDERS[render](*scene, "cuda")
    assert "d2h_pinned_bytes" not in want.info
    np.testing.assert_array_equal(got.items, want.items)
    assert got.image.tobytes() == want.image.tobytes()


@pytest.mark.cuda
def test_card_call_sites_are_byte_equal_to_the_plain_route(cuda, plain_route):
    """sorted_lists (u32 and u64), the host copies of blocks and library,
    the image, its bands, a tinted band and the sliced scorers."""
    rng = np.random.default_rng(11)
    gen = torch.Generator(device=cuda).manual_seed(11)
    dist = torch.randint(0, 255 * 768 + 1, (512, 1024), dtype=torch.int32, device=cuda,
                         generator=gen)
    x = torch.from_numpy(rng.integers(0, 256, size=(2048, 768), dtype=np.uint8)).to(cuda)
    t = torch.from_numpy(rng.integers(0, 256, size=(4096, 768), dtype=np.uint8)).to(cuda)
    items = rng.integers(-64, 65, size=(64, 96)).astype(np.int32)
    stack = rng.integers(0, 256, size=(64, 16, 16, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(256, 384, 3), dtype=np.uint8)

    def sites():
        return [
            *distance.sorted_lists(dist, 255 * 768)[:1],
            *distance.sorted_lists(dist, 2**25)[:1],
            copies.to_host(x), copies.to_host(t),
            composite.compose_mosaic(items, stack, device=cuda),
            *composite.iter_bands(items, stack, 16, device=cuda),
            *composite.stream_tinted_bands(items, None, stack, 16, original_rgb=src,
                                          tint_opacity=0.5, band_budget=1 << 20, device=cuda),
            *distance.l1_topk_stripes(x, t, 64),
            *distance.l1_topk_twolevel(x, t, 64),
            distance.l1_dist_matrix(x[:256], t),
        ]

    info = {}
    with monitor.record(info):
        got = sites()
    assert info["d2h_pinned_bytes"] >= dist.numel() * 4 * 3
    plain_route()
    want = sites()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.cuda
def test_card_arrays_kept_never_see_a_later_copy(cuda):
    """An image, the lists and a host library still referenced are unchanged
    after later copies of the same sizes, and share no memory with them."""
    rng = np.random.default_rng(2)
    stack = rng.integers(0, 256, size=(64, 16, 16, 3), dtype=np.uint8)
    gen = torch.Generator(device=cuda).manual_seed(2)

    def items():
        return rng.integers(-64, 65, size=(64, 64)).astype(np.int32)

    def lists():
        d = torch.randint(0, 255 * 768 + 1, (512, 1024), dtype=torch.int32, device=cuda,
                          generator=gen)
        return distance.sorted_lists(d, 255 * 768)[0]

    def lib():
        return copies.to_host(torch.randint(0, 256, (4096, 768), dtype=torch.uint8,
                                            device=cuda, generator=gen))

    for make in (lambda: composite.compose_mosaic(items(), stack, device=cuda), lists, lib):
        first = make()
        kept = first.copy()
        later = [make() for _ in range(2)]
        assert first.tobytes() == kept.tobytes()
        for arr in later:
            assert not np.shares_memory(first, arr)
        del later


@pytest.mark.cuda
def test_card_third_render_allocates_no_page_locked_block(cuda):
    if not hasattr(torch.cuda, "host_memory_stats"):
        pytest.skip("this torch does not report its host allocator")
    scene = _card_scene(9)
    infos = [RENDERS["sequence"](*scene, "cuda").info for _ in range(3)]
    assert infos[2]["d2h_pinned_bytes"] > 0
    assert infos[2]["host_pin_allocs"] == 0
