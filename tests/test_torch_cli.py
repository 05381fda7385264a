"""The whole slice: `emosaic_tpu_torch.cli` against `emosaic_tpu.cli`.

Both CLIs run on the CPU on the verify recipe's synthetic scene (a 97x64
gradient source, 120 noisy 40x40 tiles), each in its own copy of the tile
directory with its own prepared-tile cache. Output pixels, the stats PNG
and the analysis cache must be equal. Also: the port reads the JAX
package's analysis cache, imports neither jax nor emosaic_tpu, refuses
`--device cuda` without a GPU, runs `--mesh auto` on the CPU, and
raises like the JAX CLI under EMOSAIC_DISTRIBUTED with no cluster.
The no-repeat routes (`--no-repeat`, with and without `--greedy`),
`--randomize`, `-m random` (in memory and streamed), `--matcher xla`,
`--metric l2`, and `--matcher hybrid` with and without `--no-repeat` are
among the compared cases (random mode writes no stats and no analysis
cache).
"""

import io
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from emosaic_tpu import cli as jax_cli
from emosaic_tpu_torch import cli
from emosaic_tpu_torch.tiles import builder

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("scene")
    tiles = base / "tiles"
    tiles.mkdir()
    rng = np.random.default_rng(42)
    h, w = 64, 97
    y, x = np.mgrid[0:h, 0:w]
    src = np.stack(
        [x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1
    ).astype(np.uint8)
    Image.fromarray(src).save(base / "source.png")
    for i in range(120):
        c = rng.integers(0, 256, size=3)
        img = np.clip(c + rng.normal(0, 30, (40, 40, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(tiles / f"t{i:03d}.jpg", quality=90)
    return base


def _run(main, scene, work: Path, args, monkeypatch):
    """Run one CLI in `work` (a fresh copy of the scene) with relative
    paths, so both packages store the same tile paths in their caches."""
    if not work.exists():
        shutil.copytree(scene, work)
    monkeypatch.chdir(work)
    monkeypatch.setenv("XDG_CACHE_HOME", str(work / "xdg"))
    monkeypatch.setenv("EMOSAIC_PREP_WORKERS", "0")
    assert main(["-s", "16", "-o", "out.png", "source.png", "mosaic", "tiles", *args]) == 0


def _npz_members(path: Path) -> dict:
    """Name -> bytes of each member of an npz file. The zip headers carry a
    write time, so the files are compared member by member."""
    with zipfile.ZipFile(io.BytesIO(path.read_bytes())) as z:
        return {n: z.read(n) for n in z.namelist()}


def _pixels(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


CASES = {
    "mode1-lut": ["-m", "1"],  # 97x64 = 6208 blocks >= 4096: the LUT
    "mode1-argmin": ["-m", "1", "--downsample", "2"],  # 1536 blocks: K1's path
    "mode2": ["-m", "2"],
    "mode4": ["-m", "4"],
    "tint": ["-m", "1", "--downsample", "2", "-t", "0.3"],
    "banded": ["-m", "2", "--stream-threshold", "0"],
    "banded-tint": ["-m", "1", "--downsample", "2", "-t", "0.5", "--stream-threshold", "0"],
    # 16x10 = 160 blocks, at most the 240 rows of 120 tiles and their flips
    "no-repeat": ["-m", "2", "--downsample", "3", "--no-repeat"],
    "no-repeat-greedy": ["-m", "2", "--downsample", "3", "--no-repeat", "--greedy"],
    "randomize": ["-m", "2", "--randomize", "10", "--seed", "3"],
    # one tile per source pixel: 97x64 tiles of 16x16
    "random": ["-m", "random", "--seed", "5"],
    "random-streamed": ["-m", "random", "--seed", "5", "--stream-threshold", "0"],
    "matcher-xla": ["-m", "2", "--matcher", "xla"],
    "metric-l2": ["-m", "2", "--metric", "l2"],
    # 240 library rows: the hybrid routes to the exact stripes (D = 12)
    "matcher-hybrid": ["-m", "2", "--matcher", "hybrid"],
    "no-repeat-hybrid": ["-m", "2", "--downsample", "3", "--no-repeat", "--matcher", "hybrid"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(scene, tmp_path, monkeypatch, case):
    args = CASES[case]
    _run(jax_cli.main, scene, tmp_path / "jax", args, monkeypatch)
    _run(cli.main, scene, tmp_path / "port", [*args, "--device", "cpu"], monkeypatch)
    j, p = tmp_path / "jax", tmp_path / "port"
    np.testing.assert_array_equal(_pixels(p / "out.png"), _pixels(j / "out.png"))
    random = "random" in args
    # the tint route returns before the stats; random mode keeps none
    has_stats = "-t" not in args and not random
    for d in (j, p):
        assert (d / "out.stats.png").exists() == has_stats
    if has_stats:
        assert (p / "out.stats.png").read_bytes() == (j / "out.stats.png").read_bytes()
    caches = [sorted((d / "tiles").glob(".emosaic_*to1")) for d in (j, p)]
    assert [c.name for c in caches[1]] == [c.name for c in caches[0]]
    assert len(caches[0]) == (0 if random else 1)
    for jc, pc in zip(*caches):
        assert _npz_members(pc) == _npz_members(jc)


def test_port_reads_the_jax_analysis_cache(scene, tmp_path, monkeypatch):
    work = tmp_path / "shared"
    _run(jax_cli.main, scene, work, ["-m", "4"], monkeypatch)
    want = _pixels(work / "out.png")
    cache = work / "tiles" / ".emosaic_16to1"
    before = cache.read_bytes()
    (work / "out.png").unlink()

    def no_analysis(*a, **k):
        raise AssertionError("the port re-analysed instead of reading the cache")

    monkeypatch.setattr(builder, "generate_tile_set", no_analysis)
    _run(cli.main, scene, work, ["-m", "4", "--device", "cpu"], monkeypatch)
    np.testing.assert_array_equal(_pixels(work / "out.png"), want)
    assert cache.read_bytes() == before


def _hygiene_run(scene, work, args):
    """Run the port's CLI in a fresh process; it must finish without jax or
    emosaic_tpu in sys.modules."""
    shutil.copytree(scene, work)
    code = (
        "import sys\n"
        "from emosaic_tpu_torch.cli import main\n"
        f"rc = main(['-s', '8', '-o', 'o.png', 'source.png', 'mosaic', 'tiles', *{args!r},"
        " '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'emosaic_tpu'))\n"
        "assert rc == 0 and not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ, XDG_CACHE_HOME=str(work / "xdg"), EMOSAIC_PREP_WORKERS="0")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=work, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout
    assert (work / "o.png").exists()


def test_port_cli_imports_neither_jax_nor_emosaic_tpu(scene, tmp_path):
    _hygiene_run(scene, tmp_path / "hygiene", ["-m", "2"])


def test_port_no_repeat_cli_imports_neither_jax_nor_emosaic_tpu(scene, tmp_path):
    """The no-repeat route (the top-k scorers, the native engine) and the
    native trim of the tile prep stay jax-free too."""
    _hygiene_run(scene, tmp_path / "hygiene", ["-m", "2", "--downsample", "3", "--no-repeat"])


@pytest.mark.parametrize("args", [["-m", "random"], ["-m", "2", "--matcher", "hybrid"],
                                  ["-m", "2", "--metric", "l2"]])
def test_port_fast_mode_clis_import_neither_jax_nor_emosaic_tpu(scene, tmp_path, args):
    _hygiene_run(scene, tmp_path / "hygiene", args)


def test_device_cuda_without_gpu_raises(scene, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda runs instead of raising")
    work = tmp_path / "nogpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(cli.main, scene, work, ["-m", "1", "--device", "cuda"], monkeypatch)
    assert not (work / "out.png").exists()


def test_device_defaults_to_cuda():
    args = cli.build_parser().parse_args(["x.png", "mosaic", "tiles"])
    assert args.device == "cuda"


@pytest.mark.parametrize("pre,post", [([], ["--mesh", "auto"])])
def test_unported_flags_raise(scene, tmp_path, monkeypatch, pre, post):
    """`--mesh auto --device cpu` runs: on the one CPU device it resolves to
    a single device, so the PNG and the stats PNG equal the JAX CLI's
    `--mesh auto` (a mesh over conftest's 8 CPU devices) on the scene."""
    _run(jax_cli.main, scene, tmp_path / "jax", [*pre, *post], monkeypatch)
    _run(cli.main, scene, tmp_path / "port", [*pre, *post, "--device", "cpu"], monkeypatch)
    for name in ("out.png", "out.stats.png"):
        np.testing.assert_array_equal(
            _pixels(tmp_path / "port" / name), _pixels(tmp_path / "jax" / name)
        )


def test_no_repeat_with_randomize_is_refused_like_jax(scene, monkeypatch):
    monkeypatch.chdir(scene)
    argv = ["-s", "16", "source.png", "mosaic", "tiles", "-m", "2", "--downsample", "3",
            "--no-repeat", "--greedy", "--randomize", "10"]
    with pytest.raises(ValueError, match="deadlocks"):
        jax_cli.main(argv)
    with pytest.raises(ValueError, match="deadlocks"):
        cli.main([*argv, "--device", "cpu"])


def test_distributed_env_raises(scene, monkeypatch):
    """EMOSAIC_DISTRIBUTED=1 with no cluster environment: both CLIs raise
    the JAX package's RuntimeError instead of rendering alone."""
    monkeypatch.chdir(scene)
    for k in ("EMOSAIC_COORDINATOR", "EMOSAIC_NUM_PROCESSES", "EMOSAIC_PROCESS_ID",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EMOSAIC_DISTRIBUTED", "1")
    what = "EMOSAIC_DISTRIBUTED=1 but the multi-controller runtime could not initialize"
    with pytest.raises(RuntimeError, match=what):
        jax_cli.main(["-s", "16", "source.png", "mosaic", "tiles"])
    with pytest.raises(RuntimeError, match=what):
        cli.main(["-s", "16", "source.png", "mosaic", "tiles", "--device", "cpu"])
    assert not (scene / "output.jpg").exists()


def _package_data(pkg: str) -> tuple[list, set]:
    """(every non-Python file under `pkg`'s directory, those that the
    package-data patterns of `pyproject.toml` ship)."""
    import tomllib

    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]
    base = ROOT / pkg.replace(".", "/")
    files = sorted(p for p in base.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".py")
    return files, {p for pat in data.get(pkg, []) for p in base.glob(pat)}


def test_packaging_names_the_port():
    """`pyproject.toml`: the `torch` extra and the port's console scripts,
    beside the JAX package's dependencies and scripts; every file under
    `csrc/` (the kernels, the C++ engine and the `.cuh` header that K4 and
    K9 include) ships, so an installed port can build its kernels."""
    import importlib
    import tomllib

    proj = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]
    assert proj["dependencies"] == ["jax", "numpy", "Pillow"]
    assert proj["optional-dependencies"]["torch"] == ["torch", "numpy", "Pillow"]
    target = proj["scripts"]["emosaic-tpu-torch"]
    assert target == "emosaic_tpu_torch.cli:main"
    mod, fn = target.split(":")
    assert getattr(importlib.import_module(mod), fn) is cli.main
    assert proj["scripts"]["emosaic-tpu"] == "emosaic_tpu.cli:main"
    assert proj["scripts"]["emosaic-tpu-serve"] == "emosaic_tpu.serve:main"
    target = proj["scripts"]["emosaic-tpu-torch-serve"]
    assert target == "emosaic_tpu_torch.serve:main"
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
    files, shipped = _package_data("emosaic_tpu_torch")
    csrc = [p for p in files if p.parent == ROOT / "emosaic_tpu_torch/csrc"]
    assert {p.suffix for p in csrc} == {".cu", ".cuh", ".cpp"}
    assert [p.name for p in csrc if p not in shipped] == []


@pytest.mark.parametrize("pkg", ["emosaic_tpu_torch.web", "emosaic_tpu_torch.aws"])
def test_packaging_ships_the_web_and_aws_files(pkg):
    files, shipped = _package_data(pkg)
    assert files and [p for p in files if p not in shipped] == []
