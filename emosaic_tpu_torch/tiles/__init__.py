"""Tile data layer: Tile/TileSet containers, analysis cache, library builder.

Import the submodules directly; this file imports nothing, so
`tiles.tileset` loads without torch or Pillow."""
