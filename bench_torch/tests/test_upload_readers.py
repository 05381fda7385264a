"""The readers of the `host-device copies` layer's upload counters
(`copies.h2d_pinned_pct`, `copies.host_registers`): nothing without the
counters, as a program without registered uploads leaves its renders'
records, and the means over the window's renders with them."""

import pytest
import torch

from bench_torch import harness, spec
from bench_torch.scene import sizes

NAMES = ("copies.h2d_pinned_pct", "copies.host_registers")


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
                                   [{"d2h_bytes": 100, "d2h_pinned_bytes": 100,
                                     "host_pin_allocs": 0}, {"refill_events": 3}]])
def test_no_upload_reading_without_the_upload_counters(name, infos):
    """The records of a program that counts copies to the host but not uploads."""
    assert _read(name, _run(infos)) is None


def test_the_upload_means_with_the_counters():
    run = _run([
        {"h2d_bytes": 214, "h2d_pinned_bytes": 201, "host_registers": 2},
        {"h2d_bytes": 214, "h2d_pinned_bytes": 201, "host_registers": 0},
        {"h2d_bytes": 13},  # only the photo: no kept array uploaded
        {"d2h_bytes": 50},  # no upload counted at all: not a render of the mean
        None,  # a failed render
    ])
    assert _read("copies.h2d_pinned_pct", run) == pytest.approx(2 * 100 * 201 / 214 / 3)
    assert _read("copies.host_registers", run) == pytest.approx(2 / 3)


def test_a_window_with_every_array_registered_reads_zero():
    run = _run([{"h2d_bytes": 664, "h2d_pinned_bytes": 614, "host_registers": 0}] * 4)
    assert _read("copies.host_registers", run) == 0
    assert _read("copies.h2d_pinned_pct", run) == pytest.approx(100 * 614 / 664)
