"""The port's web output (`emosaic_tpu_torch.web`) and `--profile` against
the JAX package.

The generators must write the same bytes as `emosaic_tpu.web` on the same
stats and tile set with the same clock (the widget stamps
`int(time.time())` into its asset URLs); the assets are copies; the port
CLI's `--html` and `--web` write the same files as the JAX CLI's; the
widget contract checks of `tests/test_widget_contract.py` run against a
widget the port's CLI rendered; `--profile` writes a Chrome trace that
parses and leaves the PNG unchanged; and the runs import neither jax nor
`emosaic_tpu`.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from emosaic_tpu import cli as jax_cli
from emosaic_tpu import stats as jax_stats
from emosaic_tpu import web as jax_web
from emosaic_tpu.tiles import tileset as jax_tileset
from emosaic_tpu.web import widget as jax_widget
from emosaic_tpu_torch import cli
from emosaic_tpu_torch import stats as port_stats
from emosaic_tpu_torch import web as port_web
from emosaic_tpu_torch.tiles import tileset as port_tileset
from emosaic_tpu_torch.web import widget as port_widget

# The contract checks, run here against the port's widget: the fixtures
# below (`widget_html`, `real_render`, `real_widget_html`,
# `real_page_html`) shadow that module's, so each check reads the HTML
# the port generated; the JS and CSS it reads are the JAX package's
# assets, which `test_assets_are_byte_equal` holds equal to the port's.
from tests.test_widget_contract import (  # noqa: F401
    test_assets_copied_bytewise,
    test_forward_dataset_reads_are_satisfied,
    test_forward_js_queries_resolve_in_real_widget,
    test_inline_handlers_are_exported,
    test_js_classes_exist_in_css_and_html,
    test_js_dataset_keys_emitted_by_generator,
    test_js_ids_exist_in_html_or_are_dynamic,
    test_postmessage_protocol_snapshot,
    test_reverse_emitted_classes_have_styles_or_js,
    test_reverse_emitted_data_attrs_are_read,
    test_reverse_emitted_ids_are_consumed,
)

ROOT = Path(__file__).resolve().parent.parent
NOW = 1_760_000_000.75


def make_fixture(tmp_path, stats_mod, tileset_mod):
    """`tests/test_web.py`'s fixture, built from either package's classes."""
    ts = tileset_mod.TileSet(
        palettes=np.zeros((3, 1, 3), dtype=np.uint8),
        paths=[tmp_path / f"tiles/t{i}.jpg" for i in range(3)],
        dates=["2015:03:01", None, "2020:12:25"],
    )
    stats = stats_mod.RenderStats()
    stats.push_tile(0, 0, ts.get_tile(1), 10)
    stats.push_tile(16, 0, ts.get_tile(-2), 50)
    stats.push_tile(0, 16, ts.get_tile(3), 90)
    config = stats_mod.MosaicConfig(
        tile_size=16, mode="1x1 (N=1)", no_repeat=False, greedy=False, crop=True,
        tint_opacity=0.0, downsample=1, randomize=None,
        tiles_dir=str(tmp_path / "tiles"), title='Test "Mosaic" <x>',
    )
    return ts, stats, config


def _both(tmp_path):
    return {
        "jax": (jax_web, make_fixture(tmp_path, jax_stats, jax_tileset)),
        "port": (port_web, make_fixture(tmp_path, port_stats, port_tileset)),
    }


@pytest.mark.parametrize("web", [False, True])
def test_main_page_and_widget_equal_jax(tmp_path, monkeypatch, web):
    monkeypatch.setattr("time.time", lambda: NOW)
    files = {}
    for name, (mod, (ts, stats, config)) in _both(tmp_path).items():
        out = tmp_path / name
        out.mkdir()
        mod.generate_html_with_options(
            stats, out / "m.png", out / "m.html", ts, config, web=web
        )
        files[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert sorted(files["port"]) == [
        "m.html", "m_widget.html", "mosaic-widget.css", "mosaic-widget.js"
    ]
    assert files["port"] == files["jax"]
    assert f"?v={int(NOW)}".encode() in files["port"]["m_widget.html"]


@pytest.mark.parametrize("web", [False, True])
def test_widget_alone_equals_jax(tmp_path, monkeypatch, web):
    monkeypatch.setattr("time.time", lambda: NOW)
    got = {}
    for name, (mod, (ts, stats, config)) in _both(tmp_path).items():
        out = tmp_path / f"{name}_w.html"
        mod.generate_mosaic_widget_with_options(
            stats, tmp_path / "m.png", out, ts, config, web_compatible=web
        )
        got[name] = out.read_bytes()
    assert got["port"] == got["jax"]


def test_empty_stats_raise_like_jax(tmp_path):
    for mod, (ts, _, config) in _both(tmp_path).values():
        stats = type(_)()
        with pytest.raises(ValueError, match="No tiles recorded"):
            mod.generate_html_with_options(
                stats, tmp_path / "m.png", tmp_path / "m.html", ts, config
            )


@pytest.mark.parametrize(
    "dates",
    [[], [None], ["2018:06:06"], ["notayear:01:01", "2018:06:06", "1999:1:1"],
     ["2020:12:25", None, "2015:03:01", ""]],
)
def test_extract_year_range_equals_jax(tmp_path, dates):
    got = []
    for stats_mod, tileset_mod, widget in [(jax_stats, jax_tileset, jax_widget),
                                           (port_stats, port_tileset, port_widget)]:
        ts = tileset_mod.TileSet(
            palettes=np.zeros((max(1, len(dates)), 1, 3), dtype=np.uint8),
            paths=[tmp_path / f"t{i}.jpg" for i in range(max(1, len(dates)))],
            dates=dates or [None],
        )
        stats = stats_mod.RenderStats()
        for i in range(len(dates)):
            stats.push_tile(16 * i, 0, ts.get_tile(i + 1), i)
        got.append(widget.extract_year_range(stats))
    assert got[0] == got[1]


def test_assets_are_byte_equal():
    names = sorted(p.name for p in (ROOT / "emosaic_tpu_torch/web/assets").iterdir())
    assert names == ["mosaic-widget.css", "mosaic-widget.js"]
    for name in names:
        assert (ROOT / "emosaic_tpu_torch/web/assets" / name).read_bytes() == (
            ROOT / "emosaic_tpu/web/assets" / name
        ).read_bytes()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 36x28 gradient source and 40 noisy 24x24 tiles (no EXIF dates)."""
    base = tmp_path_factory.mktemp("webscene")
    tiles = base / "tiles"
    tiles.mkdir()
    rng = np.random.default_rng(7)
    h, w = 28, 36
    y, x = np.mgrid[0:h, 0:w]
    src = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    Image.fromarray(src.astype(np.uint8)).save(base / "source.png")
    for i in range(40):
        c = rng.integers(0, 256, size=3)
        img = np.clip(c + rng.normal(0, 30, (24, 24, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(tiles / f"t{i:02d}.jpg", quality=90)
    return base


def _cli(main, work, args, monkeypatch, pre=()):
    monkeypatch.chdir(work)
    monkeypatch.setenv("XDG_CACHE_HOME", str(work / "xdg"))
    monkeypatch.setenv("EMOSAIC_PREP_WORKERS", "0")
    assert main([*pre, "-s", "8", "-o", "out/m.png", "source.png", "mosaic", "tiles",
                 *args]) == 0


def _outputs(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}


@pytest.mark.parametrize("flags", [["--html"], ["--web"], ["--html", "--web"],
                                   ["--web", "--no-repeat", "--downsample", "4"]])
def test_cli_html_web_equal_jax(scene, tmp_path, monkeypatch, flags):
    """Both CLIs in one directory (local-mode tile URLs are absolute, from
    the working directory), the JAX run's outputs moved aside first."""
    monkeypatch.setattr("time.time", lambda: NOW)
    work = tmp_path / "w"
    shutil.copytree(scene, work)
    (work / "out").mkdir()
    _cli(jax_cli.main, work, ["-m", "1", *flags], monkeypatch)
    (work / "out").rename(work / "jax")
    (work / "out").mkdir()
    _cli(cli.main, work, ["-m", "1", *flags, "--device", "cpu"], monkeypatch)
    want, got = _outputs(work / "jax"), _outputs(work / "out")
    assert sorted(got) == ["m.html", "m.png", "m.stats.png", "m_widget.html",
                           "mosaic-widget.css", "mosaic-widget.js"]
    assert got == want


def test_cli_tint_skips_html_like_jax(scene, tmp_path, monkeypatch):
    work = tmp_path / "w"
    shutil.copytree(scene, work)
    (work / "out").mkdir()
    _cli(cli.main, work, ["-m", "1", "--html", "-t", "0.4", "--device", "cpu"],
         monkeypatch)
    assert sorted(_outputs(work / "out")) == ["m.png"]


def _trace_names(prof_dir: Path) -> list:
    traces = list(prof_dir.glob("*.json"))
    assert len(traces) == 1, traces
    trace = json.loads(traces[0].read_text())
    return [e.get("name", "") for e in trace["traceEvents"]]


def test_profile_writes_a_trace_and_keeps_the_png(scene, tmp_path, monkeypatch):
    work = tmp_path / "w"
    shutil.copytree(scene, work)
    (work / "out").mkdir()
    _cli(cli.main, work, ["-m", "2", "--device", "cpu"], monkeypatch)
    plain = _outputs(work / "out")
    shutil.rmtree(work / "out")
    (work / "out").mkdir()
    _cli(cli.main, work, ["-m", "2", "--device", "cpu"], monkeypatch,
         pre=["--profile", "prof"])
    assert _outputs(work / "out") == plain
    # the host activity of the run: torch's operators on the CPU
    assert any(n.startswith("aten::") for n in _trace_names(work / "prof"))


def test_profile_logs_like_jax(scene, tmp_path, monkeypatch, capsys):
    work = tmp_path / "w"
    shutil.copytree(scene, work)
    (work / "out").mkdir()
    _cli(cli.main, work, ["-m", "1", "--device", "cpu"], monkeypatch,
         pre=["--profile", "prof"])
    assert "🔬 Profiler trace written to prof" in capsys.readouterr().err
    assert _trace_names(work / "prof")


def _hygiene(scene, work, argv):
    shutil.copytree(scene, work)
    (work / "out").mkdir()
    code = (
        "import sys\n"
        "from emosaic_tpu_torch.cli import main\n"
        f"rc = main({argv!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'emosaic_tpu'))\n"
        "assert rc == 0 and not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, XDG_CACHE_HOME=str(work / "xdg"), EMOSAIC_PREP_WORKERS="0")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=work, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout


def test_html_web_run_imports_neither_jax_nor_emosaic_tpu(scene, tmp_path):
    work = tmp_path / "hygiene"
    _hygiene(scene, work, ["-s", "8", "-o", "out/m.png", "source.png", "mosaic", "tiles",
                           "-m", "1", "--html", "--web", "--device", "cpu"])
    assert (work / "out/m_widget.html").exists()


def test_profile_run_imports_neither_jax_nor_emosaic_tpu(scene, tmp_path):
    work = tmp_path / "hygiene"
    _hygiene(scene, work, ["--profile", "prof", "-s", "8", "-o", "out/m.png", "source.png",
                           "mosaic", "tiles", "-m", "2", "--device", "cpu"])
    assert _trace_names(work / "prof")


# ---------------------------------------------------------------------------
# fixtures of the imported widget contract checks, from the port
# ---------------------------------------------------------------------------


@pytest.fixture
def widget_html(tmp_path):
    ts, stats, config = make_fixture(tmp_path, port_stats, port_tileset)
    mosaic = tmp_path / "m.png"
    mosaic.write_bytes(b"\x89PNG\r\n\x1a\n")
    out = tmp_path / "m_widget.html"
    port_web.generate_mosaic_widget_with_options(
        stats, mosaic, out, ts, config, web_compatible=False
    )
    return out.read_text()


@pytest.fixture(scope="module")
def real_render(scene, tmp_path_factory):
    """The port's CLI (`--html`, mode 1, on the CPU) on the scene; returns
    the directory with its widget, main page and copied assets."""
    work = tmp_path_factory.mktemp("realwidget") / "w"
    shutil.copytree(scene, work)
    prior = os.environ.get("XDG_CACHE_HOME")
    cwd = os.getcwd()
    try:
        os.environ["XDG_CACHE_HOME"] = str(work / "xdg")
        os.chdir(work)
        rc = cli.main(["-s", "8", "-o", str(work / "m.png"), "source.png", "mosaic",
                       "tiles", "-m", "1", "--html", "--device", "cpu"])
    finally:
        os.chdir(cwd)
        if prior is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = prior
    assert rc == 0
    return work


@pytest.fixture(scope="module")
def real_widget_html(real_render):
    return (real_render / "m_widget.html").read_text()


@pytest.fixture(scope="module")
def real_page_html(real_render):
    return (real_render / "m.html").read_text()
