"""Host-side I/O: image discovery, decode/encode, EXIF, tile preparation.

This file imports nothing, so the render path (which needs only
`io.codecs`) loads without Pillow; the names `emosaic_tpu/io/__init__.py`
exports resolve here at first use."""

_EXPORTS = {
    "emosaic_tpu_torch.io.discovery": ("find_images",),
    "emosaic_tpu_torch.io.exif": ("get_exif_date", "get_orientation"),
    "emosaic_tpu_torch.io.prep": ("prepare_tile", "prepare_tile_with_date"),
}


def __getattr__(name):
    """The JAX package's package-level names (PEP 562), each imported from
    its submodule at first use."""
    for module, names in _EXPORTS.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

