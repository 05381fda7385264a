"""Renderers: matched (repeat / randomize / greedy no-repeat), global-greedy
no-repeat, and random mode.

The names `emosaic_tpu/render/__init__.py` exports resolve here at first
use; this file imports nothing."""

_EXPORTS = {
    "emosaic_tpu_torch.render.matched": ("RenderOutcome", "render_nto1"),
    "emosaic_tpu_torch.render.norepeat": ("render_nto1_no_repeat",),
    "emosaic_tpu_torch.render.random_mode": ("render_random",),
}


def __getattr__(name):
    """The JAX package's package-level names (PEP 562), each imported from
    its submodule at first use."""
    for module, names in _EXPORTS.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

