"""K2, `csrc/compose.cu`: the composite. Bytes only: the output image
written once, each distinct (tile, orientation) the grid uses read once,
and the item grid."""

import numpy as np

PATTERN = r"\bcompose_kernel\b"


def work(run):
    sz = run.sizes
    tile = sz["ts"] * sz["ts"] * 3
    used = [np.unique(items[items != 0]).size for items in run.traced_items]
    nbytes = sz["out_pixels"] * 3 + sum(used) / len(used) * tile + sz["B"] * 4
    return 0, nbytes, "int8_ops_per_s"
