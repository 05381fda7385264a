"""The plain reference against brute force and against the program on the
CPU."""

import numpy as np
import pytest
import torch

from bench_torch import reference, spec


def _sequential_greedy(d, t):
    """(distance, block, row) order; a pair is taken when its block is free
    and its tile (row mod t) unused."""
    b, l = d.shape
    out, used = np.full(b, -1), np.zeros(t, bool)
    for _, i, r in sorted((int(d[i, r]), i, r) for i in range(b) for r in range(l)):
        if out[i] < 0 and not used[r % t]:
            out[i], used[r % t] = r, True
    return out


def _l1(x, lib):
    return np.abs(x.astype(np.int64)[:, None] - lib.astype(np.int64)[None]).sum(-1)


@pytest.fixture(params=["thermometer", "cdist"])
def path(request, monkeypatch):
    """Each of the two exact distance paths."""
    if request.param == "cdist":
        monkeypatch.setattr(reference, "_THERMO_MAX_D", 0)
    return request.param


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [12, 300])
def test_distances_against_brute_force(path, bits, d):
    rng = np.random.default_rng(d + bits)
    x = rng.integers(0, 256, (37, d)).astype(np.uint8)
    lib = rng.integers(0, 256, (53, d)).astype(np.uint8)
    got = torch.cat([dd for _, dd in reference.distances(
        torch.from_numpy(x), torch.from_numpy(lib), bits)])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _l1(x >> (8 - bits), lib >> (8 - bits)))


@pytest.mark.parametrize("trial", range(12))
def test_greedy_and_nearest_against_brute_force(path, trial):
    rng = np.random.default_rng(trial)
    t = int(rng.integers(2, 30))
    b = int(rng.integers(1, 2 * t))
    hi = int(rng.choice([2, 3, 256]))  # small ranges make tie storms
    pal = torch.from_numpy(rng.integers(0, hi, (t, 4, 3)).astype(np.uint8))
    x = torch.from_numpy(rng.integers(0, hi, (b, 12)).astype(np.uint8))
    lib = reference.library_rows(pal)
    d = _l1(x.numpy(), lib.numpy())
    assert np.array_equal(reference.greedy(x, lib).numpy(), _sequential_greedy(d, t))
    assert np.array_equal(reference.nearest(x, lib).numpy(), d.argmin(1))


def test_mirror_rows_flip_the_cell_grid():
    pal = torch.arange(2 * 4 * 3, dtype=torch.uint8).reshape(2, 4, 3)
    lib = reference.library_rows(pal)
    assert torch.equal(lib[2].reshape(2, 2, 3), pal[0].reshape(2, 2, 3).flip(1))


def test_control_bits_change_distances(path):
    x = torch.tensor([[15, 16, 200]], dtype=torch.uint8)
    lib = torch.tensor([[0, 31, 207], [15, 16, 200]], dtype=torch.uint8)
    (_, exact), = reference.distances(x, lib)
    (_, coarse), = reference.distances(x, lib, bits=4)
    assert exact.tolist() == [[37, 0]] and coarse.tolist() == [[0, 0]]  # a tie at 4 bits


@pytest.mark.parametrize("no_repeat", [False, True])
def test_the_reference_equals_the_program_on_the_cpu(no_repeat):
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat
    from emosaic_tpu_torch.tiles.tileset import TileSet

    g = torch.Generator().manual_seed(5)
    t, dim, ts = 150, 4, 8
    pal = torch.randint(0, 256, (t, dim * dim, 3), dtype=torch.uint8, generator=g)
    stack = torch.randint(0, 256, (t, ts, ts, 3), dtype=torch.uint8, generator=g)
    src = torch.randint(0, 256, (48, 64, 3), dtype=torch.uint8, generator=g)
    tile_set = TileSet.from_arrays(pal.numpy(), [f"t/{i}.jpg" for i in range(t)])
    fn = render_nto1_no_repeat if no_repeat else render_nto1
    out = fn(src.numpy(), tile_set, ts, device="cpu", stack=stack.numpy(),
             log=lambda *a: None)
    sem = spec.load_module("semantics", "l1_greedy" if no_repeat else "l1_nearest")
    items, image = sem.render(src, pal, stack, {"mode": dim})
    assert np.array_equal(out.items, items.numpy())
    assert np.array_equal(out.image, image.numpy())
