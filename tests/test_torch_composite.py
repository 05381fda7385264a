"""Port parity: `emosaic_tpu_torch.ops.composite` against the JAX package.

`compose_rows` on CPU tensors runs the plain version of kernel K2; it is
held against both Pallas composite kernels in interpret mode and against
`compose_mosaic`, byte for byte. The tint is bit-exact against the
reference blend over all 256 alphas x 65536 pairs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from emosaic_tpu.ops import composite as jax_comp
from emosaic_tpu_torch.ops import composite
from emosaic_tpu_torch.ops._kernels import COMPOSE


def _case(rng, t, ts, nby, nbx):
    stack = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    items = rng.integers(-t, t + 1, size=(nby, nbx)).astype(np.int32)
    flat = items.reshape(-1)
    flat[:6] = [0, t, -t, t + 5, -(t + 5), 1]  # black, extremes, out of range
    return stack, items


def _band(items, stack):
    aug, _ = composite.augment_stack2d(stack, device="cpu")
    return composite.compose_rows(torch.from_numpy(items), aug).numpy()


@pytest.mark.parametrize("nby,nbx", [(1, 128), (2, 256)])
def test_compose_rows_matches_pallas_kernels(rng, nby, nbx):
    stack, items = _case(rng, t=5, ts=8, nby=nby, nbx=nbx)
    aug3, ts = jax_comp.augment_stack2d(stack)
    ji = jnp.asarray(items)
    got = _band(items, stack)
    dma = jax_comp._compose_rows_dma(ji, aug3, ts=ts, interpret=True)
    tr = jax_comp._compose_rows_pallas(ji, aug3, ts=ts, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(dma))
    np.testing.assert_array_equal(got, np.asarray(tr))


@pytest.mark.parametrize(
    "t,ts,nby,nbx", [(5, 4, 3, 7), (9, 12, 2, 37), (4, 20, 2, 3), (6, 16, 1, 200)]
)
def test_compose_mosaic_matches_jax(rng, t, ts, nby, nbx):
    # nbx not a multiple of 128, rows not 16-byte multiples (ts 4/12/20)
    stack, items = _case(rng, t, ts, nby, nbx)
    want = jax_comp.compose_mosaic(items, stack)
    got = composite.compose_mosaic(items, stack, device="cpu")
    assert got.shape == (nby * ts, nbx * ts, 3)
    np.testing.assert_array_equal(got, want)


def test_compose_rows_at_the_tpu_fallback_shapes(rng, monkeypatch):
    """The JAX package sends stacks over 4 GiB and calls over 131072 tiles
    to `_tr_kernel`; K2 has no such limits. Shrink both JAX limits so this
    small case takes that route there, and hold the port against it."""
    stack, items = _case(rng, t=7, ts=8, nby=2, nbx=128)
    aug3, ts = jax_comp.augment_stack2d(stack)
    monkeypatch.setattr(jax_comp, "_DMA_STACK_BYTES_MAX", aug3.size - 1)
    monkeypatch.setattr(jax_comp, "_DMA_MAX_ROWS", 128)
    assert not jax_comp._dma_dispatch_ok(2, 128, ts, aug3.size)
    tr = jax_comp._compose_rows_pallas(jnp.asarray(items), aug3, ts=ts, interpret=True)
    np.testing.assert_array_equal(_band(items, stack), np.asarray(tr))


def test_compose_mosaic_past_131072_tiles_in_one_call(rng):
    # the JAX package splits such calls (_DMA_MAX_ROWS); K2 takes them whole
    stack, items = _case(rng, t=9, ts=2, nby=2, nbx=65600)
    aug, _ = composite.augment_stack2d(stack, device="cpu")
    band = composite.compose_rows(torch.from_numpy(items), aug)
    want = jax_comp.compose_mosaic(items, stack)
    np.testing.assert_array_equal(band.numpy().reshape(want.shape), want)


def test_rows_of_matches_jax():
    t = 4
    items = np.array([0, 1, 4, 5, 99, -1, -4, -5, -99], np.int32)
    want = np.asarray(jax_comp._rows_of(jnp.asarray(items), t))
    np.testing.assert_array_equal(composite.rows_of(torch.from_numpy(items), t).numpy(), want)


def test_k2_wrapper_on_cpu_does_not_launch(rng):
    COMPOSE.launches = 0
    stack, items = _case(rng, t=3, ts=4, nby=2, nbx=5)
    _band(items, stack)
    assert COMPOSE.launches == 0


def test_compose_rows_checks_its_inputs(rng):
    stack, items = _case(rng, t=3, ts=4, nby=2, nbx=5)
    aug, _ = composite.augment_stack2d(stack, device="cpu")
    with pytest.raises(TypeError):
        composite.compose_rows(torch.from_numpy(items).to(torch.int64), aug)
    with pytest.raises(ValueError):
        composite.compose_rows(torch.from_numpy(items), aug[:, :, :5])


@pytest.mark.parametrize("band_rows", [1, 2, 8])
def test_iter_bands_matches_jax(rng, band_rows):
    stack, items = _case(rng, t=6, ts=4, nby=5, nbx=9)
    want = list(jax_comp.iter_bands(items, stack, band_rows=band_rows))
    got = list(composite.iter_bands(items, stack, band_rows, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tint", [0.0, 0.3, 0.5])
def test_stream_tinted_bands_matches_jax(rng, tint):
    stack, items = _case(rng, t=6, ts=4, nby=7, nbx=5)
    src = rng.integers(0, 256, size=(13, 11, 3), dtype=np.uint8)
    kw = dict(original_rgb=src, tint_opacity=tint, band_budget=2 * 5 * 16 * 3)
    want = list(jax_comp.stream_tinted_bands(items, None, stack, 4, **kw))
    got = list(composite.stream_tinted_bands(items, None, stack, 4, device="cpu", **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_tint_blend_matches_jax_on_odd_shapes(rng):
    mosaic = rng.integers(0, 256, size=(24, 36, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    for tint in (0.1, 0.5, 0.999):
        np.testing.assert_array_equal(
            composite.tint_blend(mosaic, src, tint, device="cpu"),
            jax_comp.tint_blend(mosaic, src, tint),
        )


@pytest.fixture
def one_torch_thread():
    """256 small calls: one intra-op thread keeps them fast when other
    test processes hold the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_tint_blend_bit_exact_exhaustive(one_torch_thread):
    """All 256 alphas x 65536 (mosaic, source) channel pairs against the
    JAX package's scalar port of the reference blend."""
    m = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None], (256, 256, 3))
    s = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None], (256, 256, 3))
    for alpha in range(256):
        want = m if alpha == 0 else jax_comp.ref_tint_blend_u8(m, s, alpha)
        got = composite.tint_blend(m, s, (alpha + 0.5) / 255.0, device="cpu")
        assert (got == want).all(), f"alpha={alpha}: {(got != want).sum()} diffs"
    assert (jax_comp.ref_tint_blend_u8(m, s, 0) == m).all()


def test_tint_host_helpers_are_the_jax_ones():
    for alpha in (0, 1, 127, 128, 255):
        np.testing.assert_array_equal(
            composite.tint_scalars(alpha), jax_comp.tint_scalars(alpha)
        )
    for args in [(5, 7, 3, 4, 20, 0), (3, 9, 13, 11, 40, 17)]:
        for g, w in zip(
            composite._tint_sample_indices(*args), jax_comp._tint_sample_indices(*args)
        ):
            np.testing.assert_array_equal(g, w)
    x = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        composite._u8_over_255_f32(torch.from_numpy(x)).numpy(),
        np.asarray(jax_comp._u8_over_255_f32(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        composite._u8_over_255_f32(torch.from_numpy(x)).numpy(),
        x.astype(np.float32) / np.float32(255.0),
    )
