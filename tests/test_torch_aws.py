"""The port's copy of the flag backend (`emosaic_tpu_torch/aws/`).

Every file is the JAX package's, byte for byte, apart from the README's
`python -m ...tile_manager` lines, which name the port's module. The
Lambda and `tile_manager` cases of `tests/test_aws.py` run here against
the port's copies, loaded by path as that file loads the JAX package's:
the `backend` and `manager` fixtures below shadow that module's. The
widget's rate limit and batch cap (the port's JS) equal the port's
Lambdas'.
"""

import importlib.util
import re
import sys
import types
from pathlib import Path

import pytest

from tests.test_aws import (  # noqa: F401
    FakeTable,
    test_admin_bad_page_size_falls_back,
    test_admin_pagination_and_summary,
    test_daily_quota_covers_read_path,
    test_daily_quota_per_api_key,
    test_get_flags_limits,
    test_http_api_v2_event_shape_and_preflight,
    test_invalid_requests_do_not_burn_quota,
    test_malformed_json_bodies,
    test_quota_fails_open_on_ddb_error,
    test_rate_limit_10_per_minute,
    test_tile_manager_delete,
    test_tile_manager_list_and_stats,
    test_tile_manager_list_pagination,
    test_tile_manager_review_unflag_and_delete_file,
    test_toggle_and_get,
    test_toggle_validates_hash,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_AWS = ROOT / "emosaic_tpu_torch" / "aws"
JAX_AWS = ROOT / "emosaic_tpu" / "aws"
LAMBDA_DIR = PORT_AWS / "lambda"


def _files(d: Path) -> list:
    return sorted(
        p.relative_to(d).as_posix() for p in d.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts
    )


def test_aws_files_are_copies():
    assert _files(PORT_AWS) == _files(JAX_AWS)
    for rel in _files(JAX_AWS):
        port, jax = (PORT_AWS / rel).read_bytes(), (JAX_AWS / rel).read_bytes()
        if rel == "README.md":
            jax = jax.replace(b"python -m emosaic_tpu.aws.tile_manager",
                              b"python -m emosaic_tpu_torch.aws.tile_manager")
            assert b"emosaic_tpu.aws" not in port
        assert port == jax, rel
        assert (PORT_AWS / rel).stat().st_mode == (JAX_AWS / rel).stat().st_mode, rel


def test_widget_constants_match_the_port_lambdas():
    """The port's widget JS against the port's Lambdas: its rate limiter
    allows RATE_LIMIT_PER_MINUTE flags in the toggle Lambda's sliding
    window, and its flag lookups send no more hashes than MAX_HASHES."""
    js = (ROOT / "emosaic_tpu_torch/web/assets/mosaic-widget.js").read_text()
    toggle = (LAMBDA_DIR / "toggle_flag.py").read_text()
    get_flags = (LAMBDA_DIR / "get_flags.py").read_text()
    js_limit = int(re.search(r"new RateLimiter\((\d+)\)", js).group(1))
    js_default = int(re.search(r"this\.max = maxPerMinute \|\| (\d+);", js).group(1))
    js_window_ms = int(re.search(r"return now - t <=? (\d+);", js).group(1))
    py_limit = int(re.search(r"RATE_LIMIT_PER_MINUTE = (\d+)", toggle).group(1))
    py_window_s = int(re.search(r"window_start = now - (\d+)", toggle).group(1))
    assert js_limit == js_default == py_limit == 10
    assert js_window_ms == py_window_s * 1000 == 60000
    lookups = re.findall(r"tileHashes: \[([^\]]*)\]", js)
    cap = int(re.search(r"MAX_HASHES = (\d+)", get_flags).group(1))
    assert lookups and all(len(x.split(",")) <= cap for x in lookups)
    assert cap == 100


@pytest.fixture
def backend(monkeypatch):
    """`tests/test_aws.py`'s backend, on the port's Lambda files."""
    flags = FakeTable("prod-tile-flags", "tileHash")
    rates = FakeTable("prod-rate-limits", "key")

    class FakeDDB:
        def Table(self, name):
            return flags if "tile-flags" in name else rates

    fake_boto3 = types.SimpleNamespace(resource=lambda *a, **k: FakeDDB())
    monkeypatch.setitem(sys.modules, "boto3", fake_boto3)
    mods = {}
    for name in ("toggle_flag", "get_flags", "admin_get_all_flags"):
        spec = importlib.util.spec_from_file_location(name, LAMBDA_DIR / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        # registered before exec: get_flags imports toggle_flag lazily
        monkeypatch.setitem(sys.modules, name, mod)
        spec.loader.exec_module(mod)
        assert Path(mod.__file__) == LAMBDA_DIR / f"{name}.py"
        mod._TABLE = None
        if hasattr(mod, "_RATE_TABLE"):
            mod._RATE_TABLE = None
        mods[name] = mod
    return mods, flags, rates


@pytest.fixture
def manager(backend, monkeypatch):
    """The port's `tile_manager`, wired to the same fake table."""
    mods, flags, rates = backend
    spec = importlib.util.spec_from_file_location("tile_manager", PORT_AWS / "tile_manager.py")
    tm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tm)
    monkeypatch.setattr(tm, "_table", lambda env: flags)
    return tm, flags
