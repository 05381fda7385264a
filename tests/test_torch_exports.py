"""Port parity: the package-level names of `emosaic_tpu` and its `ops`,
`render`, `tiles` and `io` packages resolve in `emosaic_tpu_torch` (by a
module-level `__getattr__`, so the port's `__init__`s still import
nothing), and the two exact argmins the port adds under the JAX names,
`l1_argmin_stripes` and `l1_argmin_xla`, equal the JAX package's on the
CPU, ties included.
"""

import importlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import emosaic_tpu
import emosaic_tpu.io
import emosaic_tpu.ops
import emosaic_tpu.render
import emosaic_tpu.tiles
from emosaic_tpu.ops import distance as J
from emosaic_tpu_torch.ops import distance as P

PACKAGES = ["", ".ops", ".render", ".tiles", ".io"]


def _public(mod):
    """The names a JAX package exports: public, and not its submodules."""
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_public_name_resolves_in_the_port(sub):
    jmod = importlib.import_module("emosaic_tpu" + sub)
    tmod = importlib.import_module("emosaic_tpu_torch" + sub)
    names = _public(jmod)
    assert names
    for name in names:
        got = getattr(tmod, name)
        owner = getattr(got, "__module__", None)
        assert owner is None or owner.startswith("emosaic_tpu_torch"), (name, owner)
        # the `from package import name` form a caller switching packages uses
        ns = {}
        exec(f"from emosaic_tpu_torch{sub} import {name}", ns)
        assert ns[name] is got
    with pytest.raises(AttributeError):
        getattr(tmod, "no_such_name")


def test_ops_names_are_the_port_functions():
    import emosaic_tpu_torch.ops as ops

    assert ops.l1_topk is P.l1_topk and ops.l1_argmin_xla is P.l1_argmin_ref
    from emosaic_tpu_torch.modes import MODE_TO_N

    import emosaic_tpu_torch

    assert emosaic_tpu_torch.MODE_TO_N is MODE_TO_N


def test_tileset_imports_without_torch():
    """Spawned tile-prep workers and `tiles.tileset` load without torch."""
    code = ("import sys, emosaic_tpu_torch, emosaic_tpu_torch.tiles.tileset, "
            "emosaic_tpu_torch.tiles, emosaic_tpu_torch.io; "
            "print('torch' in sys.modules, 'PIL' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["False", "False"]


def _argmin_case(seed, b, l, d, kind):
    rng = np.random.default_rng(seed)
    if kind == "storm":  # every row repeated: the lowest of equal rows must win
        lib = np.tile(rng.integers(0, 256, size=(7, d), dtype=np.uint8), (-(-l // 7), 1))[:l]
    else:
        lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
        lib[l - 1] = lib[l // 3]  # a tie far apart
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    blocks[0] = lib[l // 3]
    blocks[-1] = lib[0]
    return blocks, lib


@pytest.mark.parametrize(
    "seed,b,l,d,kind",
    [(0, 33, 129, 3, "uniform"), (1, 17, 700, 12, "storm"), (2, 9, 300, 50, "uniform"),
     (3, 40, 1000, 48, "storm"), (4, 5, 257, 3072, "uniform")],
)
def test_l1_argmin_stripes_and_xla_match_jax(seed, b, l, d, kind):
    blocks, lib = _argmin_case(seed, b, l, d, kind)
    x, t = torch.from_numpy(blocks), torch.from_numpy(lib)
    want_s = tuple(np.asarray(a) for a in J.l1_argmin_stripes(blocks, lib))
    want_x = tuple(np.asarray(a) for a in J.l1_argmin_xla(blocks, lib))
    np.testing.assert_array_equal(want_s[1], want_x[1])
    for got, want in ((P.l1_argmin_stripes(x, t), want_s), (P.l1_argmin_xla(x, t), want_x)):
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    if kind == "storm":
        assert (P.l1_argmin_stripes(x, t)[1].numpy() < 7).all()


def test_l1_argmin_stripes_contract():
    x = torch.zeros((0, 12), dtype=torch.uint8)
    t = torch.zeros((5, 12), dtype=torch.uint8)
    d, r = P.l1_argmin_stripes(x, t)
    assert d.shape == (0,) and r.shape == (0,)
    with pytest.raises(TypeError):
        P.l1_argmin_stripes(x.int(), t)
    with pytest.raises(ValueError):
        P.l1_argmin_stripes(x, t[:0])
    with pytest.raises(ValueError):
        P.l1_argmin_stripes(x, t[:, :6])
