"""Tile data layer: Tile/TileSet containers, analysis cache, library builder.

This file imports nothing, so `tiles.tileset` loads without torch or
Pillow; the names `emosaic_tpu/tiles/__init__.py` exports resolve here at
first use."""

_EXPORTS = {
    "emosaic_tpu_torch.tiles.tile": ("Tile",),
    "emosaic_tpu_torch.tiles.tileset": ("TileSet",),
    "emosaic_tpu_torch.tiles.cache": (
        "analysis_cache_path", "load_tileset_cache", "save_tileset_cache",
    ),
    "emosaic_tpu_torch.tiles.builder": ("generate_tile_set", "load_or_generate_tile_set"),
}


def __getattr__(name):
    """The JAX package's package-level names (PEP 562), each imported from
    its submodule at first use."""
    for module, names in _EXPORTS.items():
        if name in names:
            import importlib

            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

