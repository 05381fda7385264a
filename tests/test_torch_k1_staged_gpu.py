"""K1's staged path (`csrc/l1_argmin.cu` `l1_argmin_staged`, rows wider
than 64 bytes) over a library past 65534 rows, and the launch shape a
render records for K1 (`info["match"]["k1"]`), on an NVIDIA GPU.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip
on a host without a GPU. This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_k1_staged_gpu.py -q
"""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import L1_ARGMIN
from emosaic_tpu_torch.render import matched
from emosaic_tpu_torch.tiles.tileset import TileSet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel under test is CUDA")
    return torch.device("cuda", 0)


def test_k1_staged_past_65534_rows_lowest_row_on_ties(cuda):
    """70001 rows of 3072 bytes: blocks planted at distance 0 from two or
    three rows past 65534 (in different library splits), and one tie
    between a row below 65534 and one above, take the lowest; every block
    equals `l1_argmin_ref`'s answer."""
    rng = np.random.default_rng(3072)
    l, d = 70001, 3072
    lib = torch.from_numpy(rng.integers(0, 256, size=(l, d), dtype=np.uint8)).to(cuda)
    blocks = torch.from_numpy(rng.integers(0, 256, size=(300, d), dtype=np.uint8)).to(cuda)
    lib[66000:66100] = blocks[:100]
    lib[69900:70000] = blocks[:100]
    lib[70000] = blocks[100]
    lib[67000] = blocks[100]
    lib[65535] = blocks[101]
    lib[1000] = blocks[101]
    stats = {}
    before = L1_ARGMIN.launches
    got = distance.l1_argmin(blocks, lib, stats=stats)
    want = distance.l1_argmin_ref(blocks, lib)
    torch.cuda.synchronize()
    assert L1_ARGMIN.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = got[1].cpu().numpy()
    assert (rows[:100] == np.arange(66000, 66100)).all()
    assert rows[100] == 67000 and rows[101] == 1000
    assert (got[0][:102] == 0).all()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dw, _, nsplit, per = distance._k1_plan(300, l, d, sms)
    assert nsplit > 1  # the planted rows lie in different splits
    assert stats == {"k1": {"path": "staged", "width_words": dw, "splits": nsplit,
                            "tiles_per_split": per}}


@pytest.mark.parametrize("dim,path", [(32, "staged"), (4, "reg")])
def test_render_records_k1s_path(cuda, dim, path):
    """D = 3072 takes the staged path, D = 48 the register path."""
    rng = np.random.default_rng(dim)
    t = 300
    pal = rng.integers(0, 256, size=(t, dim * dim, 3), dtype=np.uint8)
    ts = TileSet.from_arrays(pal, [f"t{i}.jpg" for i in range(t)])
    src = rng.integers(0, 256, size=(4 * dim, 6 * dim, 3), dtype=np.uint8)
    stack = rng.integers(0, 256, size=(t, 8, 8, 3), dtype=np.uint8)
    got = matched.render_nto1(src, ts, 8, device="cuda", stack=stack, log=lambda *a: None)
    k1 = got.info["match"].pop("k1")
    assert got.info["match"] == {"route": "argmin", "blocks": 24, "scored": 24, "rows": 2 * t,
                                 "width": dim * dim * 3}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dw, _, nsplit, per = distance._k1_plan(24, 2 * t, dim * dim * 3, sms)
    assert k1 == {"path": path, "width_words": dw, "splits": nsplit, "tiles_per_split": per}
    cpu = matched.render_nto1(src, ts, 8, device="cpu", stack=stack, log=lambda *a: None)
    np.testing.assert_array_equal(got.items, cpu.items)
    np.testing.assert_array_equal(got.image, cpu.image)
