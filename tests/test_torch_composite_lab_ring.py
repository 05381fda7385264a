"""Port parity: the plain version of K7, the two-stage ring of
`composite_lab.compose_rows_bulk(stages=2)`, against the TPU lab's
double-buffered composite `_mk_db_kernel` (tools/tpu_r3_experiments3.py)
at ch 128 and 256, run in Pallas interpret mode over two grid steps (the
prologue and one prefetch), byte for byte. The helpers and the other lab
kernels are in `test_torch_composite_lab.py`.
"""

import pytest

from test_torch_composite_lab import check_r3_variant


@pytest.mark.parametrize("ch", [128, 256])
def test_bulk_ref_equals_the_double_buffered_kernel(rng, ch):
    check_r3_variant(rng, ch, db=True)
