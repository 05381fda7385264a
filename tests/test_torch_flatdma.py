"""Port parity: the shortlist rescore against the TPU lab kernel
`_l1_rows_kernel2` (`tools/tpu_r19_flatdma.py`), the flat-addressed
variant of the DMA rescore.

The lab kernel reads the library as a flat [LP*sl, lw] array, one slab of
`sl` rows of `lw` lanes per candidate; K3 (`csrc/l1_rows.cu`) addresses the
library the same way, one base pointer and 64-bit row offsets, so it
covers that kernel. Here K3's plain version `_l1_rows_ref` (what
`l1_rows` runs on a CPU tensor) is held against the lab kernel through the
Pallas interpreter, the module loaded by its path, at a width that is a
multiple of 128 (the slab layout, padded to 1024 lanes) and at widths
that are not (one unpadded row per candidate).
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emosaic_tpu.ops import distance as jax_distance
from emosaic_tpu_torch.ops import distance

ROOT = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=1)
def _flatdma_tool():
    spec = importlib.util.spec_from_file_location(
        "tpu_r19_flatdma", ROOT / "tools" / "tpu_r19_flatdma.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b,lp,d,m", [(4, 256, 128, 16), (3, 128, 384, 8), (5, 200, 48, 32),
                                      (2, 300, 75, 4)])
def test_l1_rows_matches_the_flat_dma_lab_kernel(rng, b, lp, d, m):
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    libp = rng.integers(0, 256, size=(lp, d), dtype=np.uint8)
    cand = rng.integers(0, lp, size=(b, m)).astype(np.int32)
    cand[0, :3] = [0, lp - 1, 0]  # boundary and repeated rows
    mc = jax_distance._rows_dma_mc(m, d)
    want = _flatdma_tool()._l1_rows_dma2(
        jnp.asarray(blocks), jnp.asarray(cand), jnp.asarray(libp), mc=mc, interpret=True
    )
    got = distance.l1_rows(torch.from_numpy(blocks), torch.from_numpy(cand),
                           torch.from_numpy(libp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
