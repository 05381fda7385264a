"""The port's resident service (`emosaic_tpu_torch.serve.MosaicService`)
against the JAX package's, on the CPU.

Both services load the same seeded scene (`tests/test_serve.py`'s
fixture: 10 noisy 24x24 tiles and a 9x12 source), each from its own copy
of the tile directory; their PNG responses must be the same bytes for
every request option, the bands of a streamed plan equal, and the
refusals the same.
"""

import shutil

import numpy as np
import pytest

from emosaic_tpu import serve as jax_serve
from emosaic_tpu_torch import serve
from tests.test_serve import scene  # noqa: F401 — the seeded scene fixture


def _quiet(*a):
    pass


def _services(scene, tmp_path, mode, **kw):  # noqa: F811
    """(JAX service, port service) on two copies of the scene's tiles."""
    tiles = scene[0]
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name / "tiles"
        shutil.copytree(tiles, d)
        dirs.append(d)
    return (
        jax_serve.MosaicService(dirs[0], mode, 8, log=_quiet, **kw),
        serve.MosaicService(dirs[1], mode, 8, device="cpu", log=_quiet, **kw),
    )


# 9x12 source blocks at mode 1: 108; no-repeat needs at most 20 (2 x 10
# tiles), so the no-repeat cases downsample
CASES = {
    "mode1": ("1", {}),
    "mode2": ("2", {}),
    "no_repeat": ("1", {"no_repeat": True, "downsample": 3}),
    "no_repeat_greedy": ("1", {"no_repeat": True, "greedy": True, "downsample": 3}),
    "no_repeat_mode2": ("2", {"no_repeat": True, "downsample": 2}),
    "randomize_seed": ("1", {"randomize": 50.0, "seed": 7}),
    "randomize_other_seed": ("1", {"randomize": 50.0, "seed": 8}),
    "tint": ("1", {"tint": 0.5}),
    "tint_mode2": ("2", {"tint": 0.3, "downsample": 2}),
    "downsample": ("1", {"downsample": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_bytes_equal_jax(scene, tmp_path, case):  # noqa: F811
    mode, opts = CASES[case]
    jax_svc, port_svc = _services(scene, tmp_path, mode)
    src_bytes = scene[1]
    want = jax_svc.render_bytes(src_bytes, **opts)
    got = port_svc.render_bytes(src_bytes, **opts)
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    assert got == want


def test_render_bytes_of_the_host_stack_path_equal_jax(scene, tmp_path):  # noqa: F811
    """max_stack_bytes=1: no dense stack, so every plan streams and
    render_bytes encodes the bands through StreamingPNGWriter."""
    jax_svc, port_svc = _services(scene, tmp_path, "1", max_stack_bytes=1)
    assert port_svc.stack is None and jax_svc.stack is None
    for opts in ({}, {"tint": 0.5}):
        assert port_svc.render_bytes(scene[1], **opts) == jax_svc.render_bytes(
            scene[1], **opts
        )


@pytest.mark.parametrize("opts", [{}, {"tint": 0.5}, {"no_repeat": True, "downsample": 3}])
def test_streamed_plan_bands_equal_jax(scene, tmp_path, opts):  # noqa: F811
    jax_svc, port_svc = _services(scene, tmp_path, "1")
    plans = [
        svc.render_plan(scene[1], stream_threshold=1, **opts)
        for svc in (jax_svc, port_svc)
    ]
    for plan in plans:
        assert plan[0] == "stream"
    assert plans[1][1:3] == plans[0][1:3]
    want = [np.asarray(b) for b in plans[0][3]]
    got = [np.asarray(b) for b in plans[1][3]]
    assert [b.shape for b in got] == [b.shape for b in want]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_unencoded_plan_is_the_decoded_png(scene, tmp_path):  # noqa: F811
    import io

    from PIL import Image

    _, port_svc = _services(scene, tmp_path, "1")
    kind, image = port_svc.render_plan(scene[1], tint=0.5, encode=False)
    assert kind == "image"
    png = port_svc.render_bytes(scene[1], tint=0.5)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), image)


# the no-repeat warmup request must fit the 20 library rows: 5x4 blocks
@pytest.mark.parametrize("w,h,no_repeat,line", [(24, 16, False, "warmup 24x16: "),
                                                 (5, 4, True, "warmup 5x4 (+no-repeat): ")])
def test_warmup_runs(scene, w, h, no_repeat, line):  # noqa: F811
    msgs = []
    svc = serve.MosaicService(scene[0], "1", 8, device="cpu", log=lambda *a: msgs.append(a))
    svc.warmup(w, h, no_repeat=no_repeat)
    assert any(line in str(m) for m in msgs)
    assert svc.render_bytes(scene[1])[:4] == b"\x89PNG"


@pytest.mark.parametrize(
    "mode,size,match",
    [("random", 8, "random"), ("16", 10, "not divisible"), ("4", 6, "not divisible")],
)
def test_refusals_like_jax(scene, tmp_path, mode, size, match):  # noqa: F811
    for make in (
        lambda: jax_serve.MosaicService(scene[0], mode, size, log=_quiet),
        lambda: serve.MosaicService(scene[0], mode, size, device="cpu", log=_quiet),
    ):
        with pytest.raises(ValueError, match=match):
            make()


def test_no_repeat_insufficient_tiles_like_jax(scene, tmp_path):  # noqa: F811
    jax_svc, port_svc = _services(scene, tmp_path, "1")
    msgs = []
    for svc in (jax_svc, port_svc):
        with pytest.raises(ValueError, match="Insufficient tiles") as e:
            svc.render_bytes(scene[1], no_repeat=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_service_defaults_to_cuda(scene):  # noqa: F811
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device runs instead of raising")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.MosaicService(scene[0], "1", 8, log=_quiet)
