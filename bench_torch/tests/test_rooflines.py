"""Each kernel's count of operations and bytes against a hand count, and
the share the trace gives."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_torch import roofline, spec
from bench_torch.trace import Trace

PEAKS = {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1.979e15, "fp32_flops_per_s": 6.7e13}
M32 = {"B": 16384, "L": 65534, "D": 3072, "ts": 32, "out_pixels": 4096 ** 2}
M4 = {"B": 262144, "L": 65534, "D": 48, "ts": 16, "out_pixels": 8192 ** 2}


def _run(sizes, **kw):
    return SimpleNamespace(sizes=sizes, kernel=lambda n: spec.load_module("kernels", n),
                           peaks=PEAKS, **kw)


def test_k9_plan_and_work_at_the_flagship():
    k9 = spec.load_module("kernels", "k9")
    # 1024 cells x 3 channels in groups of 32 cells: 96 coordinates;
    # 65534 rows in 512 segments of 128, 16 kept a segment
    assert k9.plan(3072, 65534) == (96, 512, 16)
    assert k9.plan(48, 200000) == (6, 1563, 8)  # 16 cells in groups of 8
    ops, nbytes, peak = k9.work(_run(M32))
    assert ops == 2 * 16384 * 65534 * 96
    assert nbytes == 4 * (16384 * 96 + 65536 * 96 + 65536 + 16384) + 8 * 16384 * 512 * 16
    assert peak == "fp32_flops_per_s"


@pytest.mark.parametrize("d,l", [(3072, 65534), (48, 65534), (48, 200000), (768, 4096),
                                 (192, 300000)])
def test_k9_plan_is_the_scorers(d, l):
    from emosaic_tpu_torch.ops.distance import _ad_plan

    _, g, chan, _, _, nseg, _, cap, _ = _ad_plan(16384, l, d, 512)
    dout = (d // 3 // g * 3) if chan else d // g
    assert spec.load_module("kernels", "k9").plan(d, l) == (dout, nseg, cap)


def test_k1_work_counts_distinct_blocks():
    run = _run(M4, traced_sources=[0, 1], distinct_blocks=lambda i: (1000, 3000)[i])
    ops, nbytes, peak = spec.load_module("kernels", "k1").work(run)
    assert ops == 2 * 2000 * 65534 * 48
    assert nbytes == 2000 * 48 + 65534 * 48 + 2000 * 8
    assert peak == "int8_ops_per_s"


def test_k2_work_counts_the_image_and_the_tiles_used():
    items = np.array([[1, -1, 2], [2, 0, 5]])  # 4 distinct (tile, orientation)
    run = _run(dict(M4, B=6, out_pixels=6 * 256), traced_items=[items])
    ops, nbytes, _ = spec.load_module("kernels", "k2").work(run)
    assert ops == 0
    assert nbytes == 6 * 256 * 3 + 4 * 16 * 16 * 3 + 6 * 4


def test_share_is_the_least_time_over_the_kernel_time():
    tr = Trace(device=[("void coarse_topcap_kernel(args)", 0.0, 8000.0),
                       ("coarse_topcap_kernel", 10000.0, 14000.0),
                       ("compose_kernel", 14000.0, 15000.0)],
               start=0.0, end=20000.0, renders=2)
    run = _run(M32, trace=tr)
    least = 2 * 16384 * 65534 * 96 / 6.7e13
    assert roofline.share(run, "k9") == pytest.approx(100 * least / 6e-3)
    assert roofline.share(run, "k1") is None  # not in the trace: no share, not 0


def test_trace_union_and_gaps():
    tr = Trace(device=[("void a<int>(int*)", 0.0, 10.0), ("b", 5.0, 20.0),
                       ("Memcpy DtoH (Device -> Pageable)", 30.0, 40.0), ("b", 45.0, 46.0)],
               start=0.0, end=50.0, renders=1)
    assert tr.union() == [[0.0, 20.0], [30.0, 40.0], [45.0, 46.0]]
    assert tr.busy_s == pytest.approx(31e-6)
    assert dict(tr.idle_gaps()) == pytest.approx({
        "after b, before Memcpy DtoH": 10e-6,
        "after Memcpy DtoH, before b": 5e-6,
        "after b, before window end": 4e-6})
    assert tr.per_render(r"\ba\b") == pytest.approx(10e-6)
    assert tr.per_render("zzz") is None
