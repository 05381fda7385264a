"""`correct` on the CPU at tiny sizes: true for the program as it is, false
for each fault a cell can have, planted under the timed path, and false
for the control (the reference at 4 bits in the program's place)."""

import pytest

from bench_torch import control

from . import tiny

CELLS = ["generate_m32.photo", "cli_m4.photo"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(bench, cell):
    res = tiny.run(bench, cell)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


def _stale(monkeypatch, module, name):
    """A render that hands back the previous render's outcome."""
    real, last = getattr(module, name), []

    def render(*a, **kw):
        out = last[0] if last else real(*a, **kw)
        last[:] = [out]
        return out

    monkeypatch.setattr(module, name, render)


def _assigned(monkeypatch, fault):
    """`fault(rows)` applied to what the match or the assignment produces."""
    from emosaic_tpu_torch import native
    from emosaic_tpu_torch.render import matched

    real_match, real_greedy = matched.match_blocks, native.greedy_global

    def match(*a, **kw):
        d, r = real_match(*a, **kw)
        return d, fault(r.copy())

    def greedy(*a, **kw):
        r, d = real_greedy(*a, **kw)
        return fault(r.copy()), d

    monkeypatch.setattr(matched, "match_blocks", match)
    monkeypatch.setattr(native, "greedy_global", greedy)


def _half_left_out(rows):
    rows[rows.size // 2:] = -1
    return rows


def _one_altered(rows):
    rows[rows.size // 3] = (rows[rows.size // 3] + 1) % 600
    return rows


@pytest.mark.parametrize("cell", CELLS)
def test_a_render_returning_its_last_answer_fails(bench, cell, monkeypatch):
    from emosaic_tpu_torch.render import matched, norepeat

    _stale(monkeypatch, matched, "render_nto1")
    _stale(monkeypatch, norepeat, "render_nto1_no_repeat")
    assert not tiny.run(bench, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_half_left_out, _one_altered])
def test_a_match_with_blocks_left_out_or_altered_fails(bench, cell, fault, monkeypatch):
    _assigned(monkeypatch, fault)
    res = tiny.run(bench, cell)
    assert not res["correct"]
    assert res["checks"]["item_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_image_byte_altered_in_the_composite_fails(bench, cell, monkeypatch):
    from emosaic_tpu_torch.render import matched

    real = matched.compose_mosaic

    def compose(*a, **kw):
        img = real(*a, **kw).copy()
        img[img.shape[0] // 2, 3, 1] ^= 1
        return img

    monkeypatch.setattr(matched, "compose_mosaic", compose)
    res = tiny.run(bench, cell)
    assert not res["correct"]
    assert res["checks"]["item_mismatches"]["value"] == 0
    assert res["checks"]["image_byte_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_render_that_raises_fails(bench, cell, monkeypatch):
    from emosaic_tpu_torch.render import matched, norepeat

    from bench_torch import harness

    calls = []
    for module, name in ((matched, "render_nto1"), (norepeat, "render_nto1_no_repeat")):
        def render(*a, __real=getattr(module, name), **kw):
            calls.append(1)
            if len(calls) > harness.N_WARM:  # the window's renders raise
                raise RuntimeError("planted")
            return __real(*a, **kw)

        monkeypatch.setattr(module, name, render)
    res = tiny.run(bench, cell)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    assert res["checks"]["renders_failed"]["value"] == res["failed"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_three_seeds(bench, cell):
    for seed, res in control.run(bench, cell, [11, 12, 2**31 + 3], 0.2, "cpu",
                                 base=bench.root / "bench_torch"):
        assert not res["correct"], (seed, res["checks"])
        assert res["checks"]["item_mismatches"]["value"] > 0
    from bench_torch import harness  # the control left the harness's entry as it was

    assert harness.entry.__module__ == "bench_torch.harness"
