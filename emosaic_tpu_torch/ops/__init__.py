"""Device compute in torch: analysis, L1 matching, LUT, composite and tint.

The CUDA kernels are built from `csrc/` by `ops/_kernels.py` at first use.
The names `emosaic_tpu/ops/__init__.py` exports resolve here at first use;
this file imports nothing."""

_EXPORTS = {
    "emosaic_tpu_torch.ops.analysis": ("analyse_batch", "source_blocks"),
    "emosaic_tpu_torch.ops.distance": (
        "build_library", "l1_argmin", "l1_argmin_xla", "l1_dist_matrix", "l1_topk",
        "l1_topk_streamed", "l2_argmin",
    ),
    "emosaic_tpu_torch.ops.lut": ("build_l1_lut", "lut_match", "lut_match_packed", "pack_rgb"),
    "emosaic_tpu_torch.ops.composite": (
        "compose_mosaic", "iter_bands", "tint_blend", "tint_blend_band",
    ),
}


def __getattr__(name):
    """The JAX package's package-level names (PEP 562), each imported from
    its submodule at first use."""
    for module, names in _EXPORTS.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

