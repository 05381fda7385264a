"""`ops/copies.py`, the route of a device-to-host copy: the arrays it hands
on, the size rule that sends a copy to page-locked memory, the counters
it adds to a render's record, and the call sites that go through it; and
the upload of a kept host array (`to_device_kept`): its registration,
once per array, its undoing when the array is freed, its fallbacks and
its two call sites.

On the CPU the page-locked route runs with plain memory in place of the
cache's blocks (`landed`), and the kept uploads with a stand-in for the
libcuda's registration (`kept`), so their copies, views and counters are
checked here; the tests marked `cuda` hold the real route on the card to
the plain one. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_copies.py -q
"""

import gc

import numpy as np
import pytest
import torch

from emosaic_tpu_torch import monitor
from emosaic_tpu_torch.ops import analysis, composite, copies, distance
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
# Uploads of kept host arrays
# ---------------------------------------------------------------------------


class FakePages:
    """Stands in for libcuda's registration: records each call, refuses
    a range that overlaps one it holds, and fails every call if told to."""

    def __init__(self, fail=False):
        self.fail = fail
        self.live = {}  # address -> bytes
        self.calls = []  # (what, address, bytes)

    def register(self, ptr, nbytes, device):
        self.calls.append(("register", ptr, nbytes))
        if self.fail or any(p < ptr + nbytes and ptr < p + n for p, n in self.live.items()):
            return False
        self.live[ptr] = nbytes
        return True

    def unregister(self, ptr, device):
        self.calls.append(("unregister", ptr, self.live.pop(ptr, None)))
        return True

    def registered(self):
        return [(p, n) for what, p, n in self.calls if what == "register"]


def _use_pages(monkeypatch, fail=False, size_rule=True):
    pages = FakePages(fail)
    monkeypatch.setattr(copies, "_PAGES", pages)
    monkeypatch.setattr(copies, "_REGISTERED", {})
    if size_rule:  # the card's size rule on any device (uploads only: no copy to the host)
        monkeypatch.setattr(copies, "_page_locked", lambda device, nbytes: nbytes >= BIG)
    return pages


@pytest.fixture
def kept(monkeypatch):
    """Registrations that succeed, and the card's size rule on the CPU."""
    return _use_pages(monkeypatch)


def _host(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def test_a_kept_array_is_registered_once_over_many_uploads(kept):
    a = _host(3 * BIG + 5).reshape(-1, 1)
    info = {}
    with monitor.record(info):
        outs = [copies.to_device_kept(x, "cpu") for x in (a, a, a.reshape(-1), a[:], a)]
    assert kept.registered() == [(a.ctypes.data, a.nbytes)]
    assert info["host_registers"] == 1
    assert info["h2d_bytes"] == info["h2d_pinned_bytes"] == 5 * a.nbytes
    for out in outs:
        assert out.dtype == torch.uint8 and out.numpy().tobytes() == a.tobytes()


def test_a_cpu_tensor_and_its_array_views_register_once(kept):
    t = torch.from_numpy(_host(BIG, 1))
    for x in (t, t.numpy(), t.numpy(), t.view(-1, 64), t):
        assert torch.equal(copies.to_device_kept(x, "cpu").reshape(-1), t)
    assert kept.registered() == [(t.data_ptr(), BIG)]
    ptr = t.data_ptr()
    del t, x
    gc.collect()
    assert kept.calls[-1] == ("unregister", ptr, BIG) and not kept.live
    assert not copies._REGISTERED


def test_a_freed_array_is_unregistered_and_its_address_registers_again(kept):
    buf = bytearray(2 * BIG)
    a = np.frombuffer(buf, dtype=np.uint8)
    ptr = a.ctypes.data
    copies.to_device_kept(a, "cpu")
    copies.to_device_kept(a, "cpu")
    assert kept.calls == [("register", ptr, 2 * BIG)]
    del a
    gc.collect()
    assert kept.calls[-1] == ("unregister", ptr, 2 * BIG)
    assert not kept.live and not copies._REGISTERED
    b = np.frombuffer(buf, dtype=np.uint8)  # a new array at the same address
    buf[:4] = b"\x01\x02\x03\x04"
    info = {}
    with monitor.record(info):
        out = copies.to_device_kept(b, "cpu")
    assert info["host_registers"] == 1 and kept.live == {ptr: 2 * BIG}
    assert out[:5].tolist() == [1, 2, 3, 4, 0]


def test_a_view_of_a_kept_array_is_unregistered_with_its_base_only(kept):
    base = _host(4 * BIG, 2)
    view = base[BIG:]
    copies.to_device_kept(view, "cpu")
    ptr = view.ctypes.data
    del view
    gc.collect()
    assert kept.live == {ptr: 3 * BIG}  # the base still holds the memory
    del base
    gc.collect()
    assert not kept.live


def test_a_failed_registration_falls_back_to_the_pageable_upload(monkeypatch):
    pages = _use_pages(monkeypatch, fail=True)
    a = _host(BIG + 1, 3)
    info = {}
    with monitor.record(info):
        got = copies.to_device_kept(a, "meta")  # an upload: counted as one
        again = copies.to_device_kept(a, "cpu")
    assert got.device.type == "meta" and tuple(got.shape) == a.shape
    assert again.numpy().tobytes() == a.tobytes()
    assert pages.registered() == [(a.ctypes.data, a.nbytes)] * 2  # tried each time
    assert info["h2d_bytes"] == a.nbytes and "h2d_pinned_bytes" not in info
    assert info["host_registers"] == 0
    assert not copies._REGISTERED


def _plain_cases():
    """(name, array) that take `to_device_u8` whatever the target."""
    big = _host(4 * BIG, 4)
    ro = big.copy()
    ro.flags.writeable = False
    return {
        "small": big[: BIG - 1],
        "read_only": ro,
        "strided": big[::2],
        "transposed": big.reshape(64, -1).T,
        "broadcast": np.broadcast_to(big[:1024], (BIG // 1024 + 1, 1024)),
        "int32": big.view(np.int32),
        "list": big[:16].tolist(),
    }


@pytest.mark.parametrize("name", sorted(_plain_cases()))
def test_arrays_outside_the_rule_take_the_plain_path(kept, name):
    x = _plain_cases()[name]
    assert copies._keepable(x, torch.device("cuda")) is None
    info = {}
    with monitor.record(info):
        out = copies.to_device_kept(x, "meta")
        got = copies.to_device_kept(x, "cpu")
    want = analysis.to_device_u8(x, "cpu")
    assert kept.calls == [] and "host_registers" not in info
    assert tuple(out.shape) == tuple(want.shape) and torch.equal(got, want)
    assert info["h2d_bytes"] == want.nbytes and "h2d_pinned_bytes" not in info


@pytest.mark.parametrize("device,keepable", [
    ("cuda", True), ("cuda:1", True), ("cpu", False), ("meta", False)])
def test_the_kept_route_takes_cuda_targets_only(monkeypatch, device, keepable):
    """The real size rule: a CPU target, or any other, uploads nothing to
    register for."""
    pages = _use_pages(monkeypatch, size_rule=False)
    a = _host(BIG, 5)
    assert (copies._keepable(a, torch.device(device)) is not None) is keepable
    assert (copies._keepable(a[1:], torch.device(device)) is not None) is False
    if not keepable:
        copies.to_device_kept(a, device)
        assert pages.calls == []


def test_the_counters_add_up(kept):
    a, photo = _host(2 * BIG, 6), _host((512, 512, 3), 7)
    ro = a.copy()
    ro.flags.writeable = False
    info = {}
    with monitor.record(info):
        copies.to_device_kept(a, "meta")
        copies.to_device_kept(a, "meta")
        copies.to_device_u8(photo, "meta")
        analysis.source_blocks(photo, 4, device="meta")
        copies.to_device_kept(ro, "meta")
        copies.to_device_kept(a, "cpu")  # registered memory, on the CPU
        copies.to_device_u8(photo, "cpu")  # nothing crosses
    assert info["h2d_pinned_bytes"] == 3 * a.nbytes
    assert info["h2d_bytes"] == 3 * a.nbytes + 2 * photo.nbytes + ro.nbytes
    assert info["host_registers"] == 1 and len(kept.registered()) == 1
    copies.to_device_kept(a, "meta")  # no record open: nothing counted
    copies.to_device_u8(photo, "meta")
    assert info["h2d_bytes"] == 3 * a.nbytes + 2 * photo.nbytes + ro.nbytes


def test_source_blocks_never_registers(monkeypatch):
    """The photo is per-request data: even past the size rule it is
    uploaded as it is, on any device."""
    pages = _use_pages(monkeypatch)
    monkeypatch.setattr(copies, "_page_locked", lambda device, nbytes: True)
    photo = _host((256, 256, 3), 8)
    for device in ("cpu", "meta"):
        analysis.source_blocks(photo, 4, device=device)
    assert pages.calls == []


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_renders_register_the_palettes_and_the_stack_only(request, monkeypatch, render):
    """Every copy past the size rule, on the `landed` route both ways."""
    scene = _scene(4)
    want = RENDERS[render](*scene, "cpu")
    request.getfixturevalue("landed")
    pages = _use_pages(monkeypatch, size_rule=False)
    src, tiles, ts, stack = scene
    outs = [RENDERS[render](*scene, "cpu") for _ in range(3)]
    assert sorted(pages.registered()) == sorted(
        [(tiles.palettes.ctypes.data, tiles.palettes.nbytes), (stack.ctypes.data, stack.nbytes)])
    assert src.ctypes.data not in pages.live
    for i, got in enumerate(outs):
        np.testing.assert_array_equal(got.items, want.items)
        np.testing.assert_array_equal(got.image, want.image)
        assert got.info["host_registers"] == (2 if i == 0 else 0)
        assert got.info["h2d_pinned_bytes"] == tiles.palettes.nbytes + stack.nbytes
        assert got.info["h2d_bytes"] == got.info["h2d_pinned_bytes"]  # the photo stays on the CPU
    del scene, tiles, stack, outs, got, want
    gc.collect()
    assert not pages.live


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
