"""The readers of the `host-device copies` layer's counters
(`copies.pinned_pct`, `copies.pin_allocs`): nothing without the counters,
as a program without `ops/copies.py` leaves its renders' records, and the
means over the window's renders with them."""

import pytest
import torch

from bench_torch import harness, spec
from bench_torch.scene import sizes

NAMES = ("copies.pinned_pct", "copies.pin_allocs")


def _run(infos):
    cfg = {"mode": 16, "tile_size": 32, "tiles": 64, "source_height": 128,
           "source_width": 128}
    run = harness.Run(cell={}, cfg=cfg, traffic={}, sizes=sizes(cfg), scene=None,
                      device=torch.device("cpu"), base=spec.HERE)
    run.records = [harness.Record(0, 1.0, 1, info is not None, info) for info in infos]
    return run


def _read(name, run):
    return spec.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("infos", [[], [None], [{"spans": {}}, None],
                                   [{"refill_events": 3}, {"spans": {}}]])
def test_nothing_without_the_counters(name, infos):
    assert _read(name, _run(infos)) is None


def test_the_means_with_the_counters():
    run = _run([
        {"d2h_bytes": 200, "d2h_pinned_bytes": 200, "host_pin_allocs": 2},
        {"d2h_bytes": 400, "d2h_pinned_bytes": 300, "host_pin_allocs": 0},
        {"d2h_bytes": 100},  # only plain copies: no page-locked block asked for
        None,  # a failed render
    ])
    assert _read("copies.pinned_pct", run) == pytest.approx((100 + 75 + 0) / 3)
    assert _read("copies.pin_allocs", run) == pytest.approx(2 / 3)


def test_no_allocation_count_from_a_torch_without_host_stats():
    """Bytes are counted, but a torch that does not report its host
    allocator gives no allocation count."""
    run = _run([{"d2h_bytes": 100, "d2h_pinned_bytes": 100}])
    assert _read("copies.pinned_pct", run) == pytest.approx(100.0)
    assert _read("copies.pin_allocs", run) is None
