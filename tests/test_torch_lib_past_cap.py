"""A library past the reference emosaic's cap of 32767 tiles (its k-d
tree ids are i16, `src/main.rs:791`, `tileset.rs:178-188`); the port has
no cap.

`render_nto1` over 33000 tiles at mode 4 on a small photo whose blocks are
built to pick tiles with items past +32767 and, as mirrors, past -32767,
with exact ties among such rows: the items and the image bytes against
the benchmark's plain reference (`bench_torch/semantics/l1_nearest.py`),
and the statistics' tile counts against the reference's items.
"""

import numpy as np
import torch

from bench_torch import harness, spec
from emosaic_tpu_torch.render import matched
from emosaic_tpu_torch.tiles.tileset import TileSet

T = 33000
DIM = 4
TS = 4
#: (tile, mirrored): blocks made of these palettes, all past the cap
PLANTED = [(32767, False), (32800, False), (32999, False), (32900, True), (32999, True),
           (32780, True), (5, True)]
#: exact ties: (tile a, tile b, b mirrored) with a's palette set equal to b's
#: row, so a block of it is at distance 0 from both rows and the lower wins
TIES = [(32950, 32990, False), (32960, 32970, True)]


def _flip(pal):
    return pal.reshape(DIM, DIM, 3)[:, ::-1].reshape(-1, 3)


def _scene():
    rng = np.random.default_rng(32768)
    pal = rng.integers(0, 256, size=(T, DIM * DIM, 3), dtype=np.uint8)
    for a, b, mirrored in TIES:
        pal[a] = _flip(pal[b]) if mirrored else pal[b]
    rows = [_flip(pal[t]) if m else pal[t] for t, m in PLANTED]
    rows += [pal[a] for a, _, _ in TIES]
    nby, nbx = 4, 6
    blocks = rng.integers(0, 256, size=(nby * nbx, DIM * DIM, 3), dtype=np.uint8)
    blocks[: len(rows)] = np.stack(rows)
    src = blocks.reshape(nby, nbx, DIM, DIM, 3).transpose(0, 2, 1, 3, 4)
    src = np.ascontiguousarray(src.reshape(nby * DIM, nbx * DIM, 3))
    stack = rng.integers(0, 256, size=(T, TS, TS, 3), dtype=np.uint8)
    return pal, src, stack


def test_render_past_the_cap_is_the_references():
    pal, src, stack = _scene()
    ts = TileSet.from_arrays(pal, [f"synthetic/{i:05d}.jpg" for i in range(T)])
    got = matched.render_nto1(src, ts, TS, device="cpu", stack=stack, log=lambda *a: None)

    cfg = {"mode": DIM, "reference": "l1_nearest"}
    want_items, want_image = harness.semantics(cfg, spec.HERE).render(
        torch.from_numpy(src), torch.from_numpy(pal), torch.from_numpy(stack), cfg)
    want_items = want_items.numpy()
    np.testing.assert_array_equal(got.items, want_items)
    np.testing.assert_array_equal(got.image, want_image.numpy())

    # the planted blocks and the ties, as items: past +32767 and past -32767
    flat = want_items.reshape(-1)
    planted = [-(t + 1) if m else t + 1 for t, m in PLANTED]
    planted += [a + 1 for a, _, _ in TIES]  # the lower row of each tie
    assert flat[: len(planted)].tolist() == planted
    assert flat.max() > 32767 and flat.min() < -32767

    # the statistics count each tile as the reference's items do
    counts = np.bincount(np.abs(flat) - 1, minlength=T)
    summary = got.stats.to_dict(ts)
    assert summary["total_tiles"] == flat.size
    assert summary["unique_images"] == np.count_nonzero(counts)
    for entry in summary["top_used"]:
        assert entry["count"] == counts[int(entry["path"][-9:-4])]
    tiles = got.stats.tiles
    for k, item in enumerate(flat):
        by, bx = divmod(k, want_items.shape[1])
        e = tiles[(bx * DIM, by * DIM)]
        assert (e.idx, e.flipped) == (abs(int(item)), item < 0)
