"""The launch plans of K1 and K3 (`ops/distance.py` `_k1_plan`,
`_k3_plan`): the Python side of the kernels, checked on the CPU.

K1 takes the register path for rows of at most 16 words (D <= 64) and the
staged path, on rows padded to 16-byte vectors, above; its library splits
cover every tile once. K3's grouped path takes rows of 512 bytes and more
and a power-of-two group of query rows that fits the shared memory beside
its sort; narrower rows, and rows too wide for one beside the sort, take
the per-query path.
"""

import pytest

from emosaic_tpu_torch.ops import distance as P


@pytest.mark.parametrize(
    "d,dw", [(3, 1), (12, 3), (27, 7), (48, 12), (61, 16), (64, 16), (65, 20), (68, 20),
             (75, 20), (192, 48), (3072, 768), (65800, 16452)]
)
def test_k1_row_width_and_path(d, dw):
    assert P._k1_plan(100, 1000, d, 132)[0] == dw
    assert (dw <= P._K1_REG_WORDS) == (d <= 64)
    if dw > P._K1_REG_WORDS:
        assert dw % 4 == 0  # whole 16-byte vectors for the staged path


@pytest.mark.parametrize(
    "b,l,d,sms",
    [(262144, 200000, 48, 132), (4096, 200000, 48, 132), (4096, 200000, 3072, 132),
     (1, 3, 3, 132), (7, 100000, 48, 132), (3, 20000, 300, 132), (1000, 257, 12, 132),
     (5, 300, 65800, 132), (1, 2**31 - 1, 3, 132), (2**20, 10**6, 48, 1)],
)
def test_k1_splits_cover_the_library(b, l, d, sms):
    dw, qtiles, nsplit, per = P._k1_plan(b, l, d, sms)
    tq, tl = P._K1_REG_TILE if dw <= P._K1_REG_WORDS else P._K1_STAGED_TILE
    ntiles = -(-l // tl)
    assert qtiles == -(-b // tq)
    assert 1 <= nsplit <= 65535 and per >= 1
    assert nsplit * per >= ntiles > (nsplit - 1) * per  # every split non-empty
    if qtiles < sms * P._BLOCKS_PER_SM and ntiles >= sms * P._BLOCKS_PER_SM:
        assert qtiles * nsplit >= sms * P._BLOCKS_PER_SM  # the grid fills the card


def test_k1_main_path_plans():
    # the mode-4 repeat path: 1024 query tiles, the library split in two
    assert P._k1_plan(262144, 200000, 48, 132) == (12, 1024, 2, 391)
    # few queries: 16 query tiles x 66 splits = 8 blocks per SM
    assert P._k1_plan(4096, 200000, 48, 132) == (12, 16, 66, 12)


@pytest.mark.parametrize("d", [3, 12, 48, 192, 496])
def test_k3_narrow_rows_take_the_per_query_path(d):
    assert P._k3_plan(1024, -(-d // 16)) == (0, 0)


@pytest.mark.parametrize(
    "m,d,want",
    [(1024, 3072, (16, 10)),     # the flagship rescore: 16 queries, one pass
     (1024, 49152, (2, 10)),     # two 48 KB rows beside the sort
     (1024, 768, (16, 10)),
     (1, 768, (64, 0)),          # the largest group
     (8192, 3072, (2, 13)),      # the flat-library probe's lists
     (20000, 3072, (1, 14)),     # longer than one pass: two passes
     (300, 512, (32, 9))],
)
def test_k3_group_and_pass(m, d, want):
    assert P._k3_plan(m, d // 16) == want


@pytest.mark.parametrize("m", [1, 7, 64, 1000, 1024, 1025, 5000, 16384, 40000])
@pytest.mark.parametrize("d", [512, 768, 3072, 12288, 49152, 131072])
def test_k3_plan_fits_the_kernel(m, d):
    nvec = d // 16
    group, mc_log2 = P._k3_plan(m, nvec)
    assert group >= 1 and group & (group - 1) == 0 and group <= P._K3_GROUP_MAX
    assert group << mc_log2 <= P._K3_ENTRIES  # one pass fits the sort
    assert P._K3_SORT_BYTES + group * nvec * 16 <= P._K3_SMEM_BYTES
    mc = 1 << mc_log2
    assert mc >= min(m, P._K3_ENTRIES // group)  # no pass is needlessly short
    assert mc < 2 * m or mc == 1  # nor needlessly long


def test_k3_rows_too_wide_for_a_group_take_the_per_query_path():
    nvec = (P._K3_SMEM_BYTES - P._K3_SORT_BYTES) // 16 + 1
    assert P._k3_plan(64, nvec) == (0, 0)
