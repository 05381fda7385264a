"""Port parity: the plain versions of the composite lab kernels K5 to K8
(`emosaic_tpu_torch.ops.composite_lab`) against the TPU lab kernels they
replace, run in Pallas interpret mode on the same numpy-seeded inputs,
byte for byte.

The tools' jitted wrappers take no `interpret` flag, so each test builds
its own `pl.pallas_call(..., interpret=True)` around the tool's kernel
body with the tool's specs:

- #5 `_floor_write_kernel` (tools/tpu_r3_experiments.py) for K5;
- #6 `_dma_kernel_unrolled` (tools/tpu_r3_experiments2.py) and #7's
  `_mk_sb_kernel` at ch 128 and 256 (tools/tpu_r3_experiments3.py, specs
  of `_compose_variant`) for K6; #7's `_mk_db_kernel` for K7 is in
  `test_torch_composite_lab_ring.py` (each file about a minute on one
  worker: an interpreted body unrolls ch copies);
- #8 `tr_kernel` (tools/tpu_bench_composite_variants.py) for K8. That
  module runs its whole benchmark when imported, so its kernel, `_gather`,
  `compose_v1`, `compose_v4` and its constants are taken out with `ast`
  and executed alone.

The r3 tools are loaded by their paths. The probes' band functions are
held against the JAX package's `_compose_rows_dma(interpret=True)` at a
tiny shape. The kernels themselves run only on a GPU
(`tests/test_torch_gpu.py`).
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from emosaic_tpu.ops import composite as jax_comp
from emosaic_tpu_torch.ops import composite, composite_lab
from emosaic_tpu_torch.ops._kernels import (
    BAND_TRANSPOSE,
    COMPOSE_BULK,
    COMPOSE_BULK2,
    FLOOR_WRITE,
    KERNELS,
)
from emosaic_tpu_torch.probes import composite_variants, r3_composite

TOOLS = Path(__file__).resolve().parent.parent / "tools"


@functools.lru_cache(maxsize=None)
def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _variants_tool():
    """`tr_kernel`, `_gather`, `compose_v1`, `compose_v4` and the constants
    of tools/tpu_bench_composite_variants.py, without running the rest."""
    path = TOOLS / "tpu_bench_composite_variants.py"
    tree = ast.parse(path.read_text())
    keep = {"tr_kernel", "_gather", "compose_v1", "compose_v4"}
    body = [
        node for node in tree.body
        if (isinstance(node, ast.FunctionDef) and node.name in keep)
        or (isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Tuple)
            and "CH" in [e.id for e in node.targets[0].elts])
    ]
    assert len(body) == 5, [getattr(n, "name", "consts") for n in body]
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _case(rng, t, ts, nby, nbx):
    """Tiles, and items with black, extreme and out-of-range entries."""
    stack = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    items = rng.integers(-t - 3, t + 4, size=(nby, nbx)).astype(np.int32)
    items.reshape(-1)[:7] = [0, t, -t, t + 5, -(t + 5), 1, 2**31 - 1]
    return stack, items


def _port_band(fn, items, stack):
    aug, _ = composite.augment_stack2d(stack, device="cpu")
    return fn(torch.from_numpy(items), aug).numpy()


def _tool_band(kernel, items, stack, *, ch, scratch):
    """The tools' DMA composite specs (`_compose_variant`), interpreted."""
    aug3, ts = jax_comp.augment_stack2d(stack)
    nby, nbx = items.shape
    rows = jax_comp._rows_of(jnp.asarray(items), aug3.shape[0] // 2).astype(jnp.int32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nby, nbx // ch),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((ts, ch * ts * 3), lambda i, j, *_: (i, j)),
        scratch_shapes=scratch(ts, aug3.shape[2]),
    )
    return np.asarray(pl.pallas_call(
        kernel,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((nby * ts, nbx * ts * 3), jnp.uint8),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(rows, aug3))


def _single(ch):
    return lambda ts, lane: [pltpu.VMEM((ch, ts, lane), jnp.uint8),
                             pltpu.SemaphoreType.DMA((ch,))]


def _double(ch):
    return lambda ts, lane: [pltpu.VMEM((2, ch, ts, lane), jnp.uint8),
                             pltpu.SemaphoreType.DMA((2, ch))]


def check_r3_variant(rng, ch, *, db):
    """#7's single- (`_mk_sb_kernel`) or double-buffered (`_mk_db_kernel`)
    body at ch, interpreted over two grid steps, against K6 at C (ch = 128)
    or 2C (ch = 256), or K7 likewise, and the JAX package's composite."""
    tool = _tool("tpu_r3_experiments3")
    ts, nby, nbx = 8, 2, ch
    stack, items = _case(rng, t=40, ts=ts, nby=nby, nbx=nbx)
    if db:
        kern = functools.partial(tool._mk_db_kernel(ch), s3=ts * 3, nsteps=nby * (nbx // ch))
    else:
        kern = functools.partial(tool._mk_sb_kernel(ch), s3=ts * 3)
    want = _tool_band(kern, items, stack, ch=ch, scratch=_double(ch) if db else _single(ch))
    run = composite_lab.RUN * ch // 128
    got = _port_band(functools.partial(composite_lab.compose_rows_bulk,
                                       stages=2 if db else 1, run=run), items, stack)
    np.testing.assert_array_equal(got, want)
    aug3, _ = jax_comp.augment_stack2d(stack)
    np.testing.assert_array_equal(
        want, np.asarray(jax_comp._compose_rows_xla(jnp.asarray(items), aug3, ts=ts)))


# ---------------------------------------------------------------------------
# K5: the write floor
# ---------------------------------------------------------------------------


def test_floor_write_ref_equals_the_tpu_floor_kernel():
    tool = _tool("tpu_r3_experiments")
    ts, ch = tool.TS, tool._CH
    seed = np.full((8, 128), 200, np.uint8)
    seed[0, 0] = 7  # only seed[0, 0] is written
    grid = (3, 2)
    want = pl.pallas_call(
        tool._floor_write_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((8, 128), lambda i, j: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((ts, ch * ts * 3), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((grid[0] * ts, grid[1] * ch * ts * 3), jnp.uint8),
        scratch_shapes=[pltpu.VMEM((ch, ts, jax_comp._lane(ts)), jnp.uint8)],
        interpret=True,
    )(jnp.asarray(seed))
    want = np.asarray(want)
    got = composite_lab.floor_write(torch.from_numpy(seed), *want.shape)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(1, 16), (7, 13), (24, 6144), (0, 5)])
def test_floor_write_shapes_and_strided_seed(h, w):
    seed = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128).to(torch.uint8)
    got = composite_lab.floor_write(seed.t(), h, w)  # a strided view: [0, 0] is 0
    assert got.shape == (h, w) and bool((got == 0).all())
    got = composite_lab.floor_write(seed[1:], h, w)
    assert bool((got == 128).all()) and got.is_contiguous()


def test_floor_write_rejects_bad_operands():
    with pytest.raises(ValueError, match="uint8"):
        composite_lab.floor_write(torch.zeros((8, 128), dtype=torch.int32), 2, 2)
    with pytest.raises(ValueError, match="uint8"):
        composite_lab.floor_write(torch.zeros(8, dtype=torch.uint8), 2, 2)
    with pytest.raises(ValueError, match="negative"):
        composite_lab.floor_write(torch.zeros((8, 128), dtype=torch.uint8), -1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        composite_lab.floor_write(torch.zeros((8, 128), dtype=torch.uint8, device="meta"), 2, 2)


# ---------------------------------------------------------------------------
# K6 and K7: the band through bulk copies
# ---------------------------------------------------------------------------


def test_bulk_ref_equals_the_unrolled_dma_kernel(rng):
    tool = _tool("tpu_r3_experiments2")
    stack, items = _case(rng, t=40, ts=8, nby=2, nbx=128)
    kern = functools.partial(tool._dma_kernel_unrolled, s3=8 * 3)
    want = _tool_band(kern, items, stack, ch=tool._CH, scratch=_single(tool._CH))
    for stages in (1, 2):
        got = _port_band(functools.partial(composite_lab.compose_rows_bulk, stages=stages),
                         items, stack)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ch", [128, 256])
def test_bulk_ref_equals_the_single_buffered_kernel(rng, ch):
    check_r3_variant(rng, ch, db=False)


@pytest.mark.parametrize("ts,nbx", [(8, 77), (16, 300), (24, 5), (32, 129)])
def test_bulk_ref_any_nbx_matches_jax(rng, ts, nbx):
    # a short last run: nbx needs no padding to a multiple of the run
    stack, items = _case(rng, t=9, ts=ts, nby=3, nbx=nbx)
    want = jax_comp.compose_mosaic(items, stack)
    for stages in (1, 2):
        got = _port_band(functools.partial(composite_lab.compose_rows_bulk, stages=stages),
                         items, stack)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_bulk_domain_is_checked_on_every_device(rng):
    stack, items = _case(rng, t=4, ts=12, nby=1, nbx=8)
    aug, _ = composite.augment_stack2d(stack, device="cpu")
    it = torch.from_numpy(items)
    with pytest.raises(ValueError, match="ts % 8"):
        composite_lab.compose_rows_bulk(it, aug)
    aug8, _ = composite.augment_stack2d(stack[:, :8, :8], device="cpu")
    with pytest.raises(ValueError, match="stages"):
        composite_lab.compose_rows_bulk(it, aug8, stages=3)
    fit = composite_lab.run_fit(8, 2)
    assert fit == (composite_lab.SMEM_MAX - 128) // (2 * 192)
    with pytest.raises(ValueError, match="does not fit"):
        composite_lab.compose_rows_bulk(it, aug8, stages=2, run=fit + 1)
    with pytest.raises(ValueError, match="does not fit"):
        composite_lab.compose_rows_bulk(it, aug8, run=0)
    with pytest.raises(TypeError, match="int32"):
        composite_lab.compose_rows_bulk(it.long(), aug8)
    with pytest.raises(ValueError, match="unsupported device"):
        composite_lab.compose_rows_bulk(it.to("meta"), aug8.to("meta"))
    # ts = 128 (the 9.8 GB stack's tiles): two stages hold 2 tiles, one 4
    assert composite_lab.run_fit(128, 2) == 2 and composite_lab.run_fit(128, 1) == 4
    assert composite_lab.run_fit(32, 2) >= 2 * composite_lab.RUN


# ---------------------------------------------------------------------------
# K8: the relayout of gathered tiles
# ---------------------------------------------------------------------------


def test_band_transpose_ref_equals_the_tpu_relayout_kernel(rng):
    tool = _variants_tool()
    ts, ch, nby, nbx = tool["TS"], tool["CH"], 2, tool["CH"]
    nt = 50
    aug = jnp.asarray(rng.integers(0, 256, size=(2 * nt, ts * ts * 3), dtype=np.uint8))
    items = jnp.asarray(rng.integers(1, nt + 1, size=(nby, nbx)).astype(np.int32))
    sel = tool["_gather"](items, aug).reshape(nby * nbx, ts, ts * 3)
    nj, ny = nbx // ch, ts // 8
    want = np.asarray(pl.pallas_call(
        tool["tr_kernel"],
        grid=(nby, nj, ny),
        in_specs=[pl.BlockSpec((ch, 8, 96), lambda i, j, y: (i * nj + j, y, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, ch * 96), lambda i, j, y: (i * ny + y, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nby * ts, nbx * ts * 3), jnp.uint8),
        interpret=True,
    )(sel))
    sel_t = torch.from_numpy(np.array(sel))
    np.testing.assert_array_equal(composite_lab.band_transpose(sel_t, nby, nbx).numpy(), want)
    # the probe's v1, v4 and v3d against the tool's v1 and v4, on the port's
    # stack layout ([2T + 1, ts, ts*3], a black row at 2T)
    aug_p = torch.from_numpy(np.concatenate(
        [np.asarray(aug), np.zeros((1, ts * ts * 3), np.uint8)]).reshape(-1, ts, ts * 3))
    it = torch.from_numpy(np.array(items))
    np.testing.assert_array_equal(np.asarray(tool["compose_v1"](items, aug, ts=ts)), want)
    np.testing.assert_array_equal(np.asarray(tool["compose_v4"](items, aug, ts=ts)), want)
    for name in ("v1", "v4", "v3d", "K2"):
        got = composite_variants.VARIANTS[name](it, aug_p)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for fn in (composite_variants.relayout_copy, composite_variants.relayout_copy_i32):
        np.testing.assert_array_equal(fn(sel_t, nby, nbx).numpy(), want)


@pytest.mark.parametrize("ts,w", [(8, 24), (3, 9), (16, 48), (1, 1)])
def test_band_transpose_ref_shapes(rng, ts, w):
    nby, nbx = 3, 5
    sel = rng.integers(0, 256, size=(nby * nbx, ts, w), dtype=np.uint8)
    got = composite_lab.band_transpose(torch.from_numpy(sel), nby, nbx).numpy()
    want = sel.reshape(nby, nbx, ts, w).transpose(0, 2, 1, 3).reshape(nby * ts, nbx * w)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="tiles"):
        composite_lab.band_transpose(torch.from_numpy(sel), nby, nbx + 1)
    with pytest.raises(ValueError, match="uint8"):
        composite_lab.band_transpose(torch.from_numpy(sel).int(), nby, nbx)


# ---------------------------------------------------------------------------
# the slice: the probes' band functions, the registry
# ---------------------------------------------------------------------------


def test_probe_bands_equal_the_jax_dma_composite(rng):
    stack, items = _case(rng, t=30, ts=8, nby=2, nbx=128)
    aug3, ts = jax_comp.augment_stack2d(stack)
    want = np.asarray(jax_comp._compose_rows_dma(jnp.asarray(items), aug3, ts=ts,
                                                 interpret=True))
    for name, (_, fn) in r3_composite.band_fns().items():
        np.testing.assert_array_equal(_port_band(fn, items, stack), want, err_msg=name)
    seq = r3_composite.sequential_items(2, 128, "cpu")
    assert seq.shape == (2, 128) and seq[0, :16].tolist() == list(range(1, 17)) \
        and seq[1, 16].item() == 1
    np.testing.assert_array_equal(
        _port_band(composite.compose_rows, seq.numpy(), stack),
        np.asarray(jax_comp._compose_rows_dma(jnp.asarray(seq.numpy()), aug3, ts=ts,
                                              interpret=True)))
    pos = np.abs(items) % 30 + 1  # composite_variants' items are in [1, T]
    want_pos = np.asarray(jax_comp._compose_rows_dma(jnp.asarray(pos), aug3, ts=ts,
                                                     interpret=True))
    for name, fn in composite_variants.VARIANTS.items():
        np.testing.assert_array_equal(_port_band(fn, pos, stack), want_pos, err_msg=name)


def test_resident_tiles_per_sm():
    # C = 16 at ts = 32: one stage of 48 KB fits four blocks (64 tiles),
    # two stages of 2C = 192 KB one block (64 tiles)
    assert r3_composite.resident_tiles(1, 16, 32) == 64
    assert r3_composite.resident_tiles(2, 16, 32) == 64
    assert r3_composite.resident_tiles(1, 32, 32) == 64
    assert r3_composite.resident_tiles(2, 32, 32) == 64


def test_registry_shares_one_source_between_k6_and_k7():
    assert COMPOSE_BULK.source == COMPOSE_BULK2.source
    assert COMPOSE_BULK.library == COMPOSE_BULK2.library
    assert COMPOSE_BULK.name != COMPOSE_BULK2.name
    assert {k.source.name for k in (FLOOR_WRITE, BAND_TRANSPOSE)} == {
        "floor_write.cu", "band_transpose.cu"}
    assert {COMPOSE_BULK, COMPOSE_BULK2, FLOOR_WRITE, BAND_TRANSPOSE} <= set(KERNELS)
    assert len({k.name for k in KERNELS}) == len(KERNELS)  # one launch counter each
    assert all(k.source.is_file() for k in KERNELS)
    shared = {}
    for k in KERNELS:
        shared.setdefault(k.source.name, set()).add(k.name)
    # the entries that share a source: K6 and K7, K10's two, K11's two
    assert {src: names for src, names in shared.items() if len(names) > 1} == {
        "compose_bulk.cu": {COMPOSE_BULK.name, COMPOSE_BULK2.name},
        "l1_topcap.cu": {"l1_stripe", "l1_topcap"},
        "l2_score.cu": {"l2_argmin", "l2_topcap"},
    }
