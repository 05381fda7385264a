"""Renderers: the matched (repeat) render of the default mosaic path."""
