"""The rate arithmetic and the end-to-end readers."""

import pytest

from bench_torch import measure


def test_rate():
    assert measure.rate(335.5, 45.0) == pytest.approx(7.4555555)
    with pytest.raises(ValueError):
        measure.rate(1.0, 0.0)


def test_metrics_of_the_window():
    from types import SimpleNamespace

    from bench_torch import spec

    recs = [SimpleNamespace(pixels=4_000_000, latency_s=0.1 * (i + 1), ok=True, info=None)
            for i in range(10)]
    run = SimpleNamespace(records=recs, window_s=2.0, setup_s=12.5)
    read = {n: spec.load_module("metrics", n).read(run)
            for n in ("mpix_per_s", "setup_s")}
    assert read == pytest.approx({"mpix_per_s": 20.0, "setup_s": 12.5})
