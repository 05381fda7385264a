"""Host-side I/O: image discovery, decode/encode, EXIF, tile preparation.

Import the submodules directly; this file imports nothing, so the render
path (which needs only `io.codecs`) loads without Pillow."""
