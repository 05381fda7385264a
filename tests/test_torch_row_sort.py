"""K13's contract on the CPU: `row_sort`'s plain version and the host lists
`sorted_lists` makes of it (u32 keys where they fit, decoded by
`unpack_lists`) against `np.argsort(kind="stable")` and `take_along_axis`, the launch plan `_k13_plan` (key width, passes, the
long-row path) against the kernel's own checks, and the wrapper's input
checks. The kernel itself runs in `tests/test_torch_gpu.py` (`cuda`)."""

import numpy as np
import pytest
import torch

from emosaic_tpu_torch.ops import _kernels
from emosaic_tpu_torch.ops import distance as D


def _numpy_lists(m):
    order = np.argsort(m, axis=1, kind="stable").astype(np.int32)
    return np.take_along_axis(m, order, axis=1).astype(np.int32), order


def _matrix(seed, rows, n, lo, hi):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, size=(rows, n)).astype(np.int32)


#: (rows, n, dmax, lo, hi): entries drawn from [lo, hi] <= dmax
CASES = {
    "random": (16, 512, 255 * 768, 0, 255 * 768),
    "random_u64": (4, 9000, 255 * 3072, 0, 255 * 3072),
    "near": (16, 700, 255 * 768, 60000, 60100),
    "tie_storm": (8, 999, 255 * 48, 0, 2),
    "all_equal": (5, 257, 255 * 48, 7, 7),
    "zeros": (3, 64, 0, 0, 0),
    "one_column": (6, 1, 255 * 768, 0, 255 * 768),
    "odd": (7, 8191, 255 * 768, 0, 255 * 768),
    "bits_32": (4, 8192, (1 << 19) - 1, (1 << 19) - 4, (1 << 19) - 1),
    "bits_33": (4, 8192, 1 << 19, (1 << 19) - 4, 1 << 19),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_lists_match_the_stable_numpy_argsort(case):
    rows, n, dmax, lo, hi = CASES[case]
    m = _matrix(n + rows, rows, n, lo, hi)
    lists, bits_c = D.sorted_lists(torch.from_numpy(m), dmax)
    key_bytes, plan_bits_c = D._k13_plan(n, dmax)[:2]
    if key_bytes == 4:  # the keys as they came from the sort, and their column bits
        assert lists.dtype == np.uint32 and lists.shape == m.shape and bits_c == plan_bits_c
    else:
        assert lists.dtype == np.int32 and lists.shape == (2, *m.shape) and bits_c is None
    cd, cr = D.unpack_lists(lists, bits_c)
    want_d, want_r = _numpy_lists(m)
    assert cd.dtype == cr.dtype == np.int32
    np.testing.assert_array_equal(cd, want_d)
    np.testing.assert_array_equal(cr, want_r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_lays_out_the_lists_as_k13_writes_them(case):
    """4-byte keys: the u32 keys (dist << bits_c) | col as int32 bits; 8-byte
    keys: the distances, then the columns, [2, B, L]."""
    rows, n, dmax, lo, hi = CASES[case]
    m = _matrix(n + rows, rows, n, lo, hi)
    out = D._row_sort_ref(torch.from_numpy(m), dmax).numpy()
    key_bytes, bits_c = D._k13_plan(n, dmax)[:2]
    want_d, want_r = _numpy_lists(m)
    if key_bytes == 4:
        keys = (want_d.astype(np.uint64) << np.uint64(bits_c)) | want_r.astype(np.uint64)
        np.testing.assert_array_equal(out.view(np.uint32), keys.astype(np.uint32))
        assert (keys < 2**32).all()
    else:
        np.testing.assert_array_equal(out, np.stack([want_d, want_r]))
    assert key_bytes == {"bits_32": 4, "bits_33": 8, "random_u64": 8}.get(case, 4)


def test_empty_matrices():
    for shape in ((0, 5), (3, 0)):
        cd, cr = D.unpack_lists(*D.sorted_lists(torch.zeros(shape, dtype=torch.int32), 765))
        assert cd.shape == cr.shape == shape


@pytest.mark.parametrize(
    "n,dmax,key_bytes",
    [(8192, (1 << 19) - 1, 4), (8192, 1 << 19, 8), (3, 2**31 - 1, 8), (2, 2**31 - 1, 4),
     (1, 2**31 - 1, 4), (65534, 255 * 48, 4), (65534, 255 * 3072, 8), (8192, 255 * 768, 4)],
)
def test_k13_key_width_follows_the_shape(n, dmax, key_bytes):
    """u32 keys exactly while bitlen(dmax) + bitlen(n - 1) <= 32."""
    assert D._k13_plan(n, dmax)[0] == key_bytes


def test_k13_plan_at_the_cell_and_the_long_row_edge():
    # `service_m16.exact_full`: 18 distance bits in 3 passes of 6, 13 column
    # bits, u32 keys, a row a block in 86 KB (two blocks an SM)
    assert D._k13_plan(8192, 255 * 768) == (4, 13, 3, 6, 0, 86080)
    # the route's longest rows at D = 3072: 20 + 16 bits, u64 keys in chunks
    assert D._k13_plan(65534, 255 * 3072) == (8, 16, 3, 7, D._K13_CHUNK, 81984)
    assert D._k13_work(3051, 65534, D._k13_plan(65534, 255 * 3072)) == (
        2 * 3051 * 65534 * 8 + 4 * 3051 * 128 * 16)


def _kernel_accepts(rows, n, plan):
    """The kernel's `plan_ok` (csrc/row_sort.cu), line by line."""
    key_bytes, bits_c, passes, width, chunk, smem = plan
    smem_of = lambda cap: 2 * cap * key_bytes + 2 * cap + 4 * 16 * ((1 << width) + 1)  # noqa: E731
    ok = (1 <= rows <= 2**31 - 1 and n >= 1 and key_bytes in (4, 8) and 1 <= width <= 8
          and passes >= 1 and 0 <= bits_c <= 31 and (1 << bits_c) >= n
          and bits_c + (passes - 1) * width < 8 * key_bytes and smem <= 232448)
    if chunk == 0:
        return ok and smem == smem_of(-(-n // 8) * 8)
    return (ok and chunk % 8 == 0 and chunk <= 65535 and -(-n // chunk) <= 65535
            and smem == smem_of(chunk))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 100, 4096, 8191, 8192, 12345, 20000, 22000,
                               30001, 65534, 10**6, 2 * 10**8])
@pytest.mark.parametrize("d", [0, 1, 3, 12, 48, 768, 3072, 49152])
def test_k13_plan_is_one_the_kernel_takes(n, d):
    dmax = 255 * d
    plan = D._k13_plan(n, dmax)
    key_bytes, bits_c, passes, width, chunk, smem = plan
    assert _kernel_accepts(3051, n, plan)
    bits_d = dmax.bit_length()
    assert passes * width >= bits_d > (passes - 1) * width or (bits_d == 0 and passes == 1)
    assert width <= D._K13_MAX_WIDTH
    # the whole row in one block wherever its shared memory allows it
    assert bool(chunk) == (D._k13_smem(-(-n // 8) * 8, key_bytes, width) > D._K13_SMEM_MAX)
    # every key and digit inside the key's bits
    assert bits_d + bits_c <= 8 * key_bytes


def test_row_sort_refuses_what_k13_does_not_take():
    with pytest.raises(ValueError, match="int32"):
        D.row_sort(torch.zeros((3, 4), dtype=torch.int64), 10)
    with pytest.raises(ValueError, match="int32"):
        D.row_sort(torch.zeros(4, dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="dmax"):
        D.row_sort(torch.zeros((3, 4), dtype=torch.int32), -1)
    with pytest.raises(ValueError, match="dmax"):
        D.row_sort(torch.zeros((3, 4), dtype=torch.int32), 2**31)


def test_k13_has_its_own_source_and_counter():
    k = _kernels.ROW_SORT
    assert k.source.name == "row_sort.cu" and k.name == "row_sort"
    assert k in _kernels.KERNELS
    assert [x.source_name for x in _kernels.KERNELS].count(k.source_name) == 1
    # device, four pointers, rows, n, six plan ints, the stream
    assert len(k.argtypes) == 14
