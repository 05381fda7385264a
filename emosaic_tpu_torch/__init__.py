"""emosaic_tpu_torch — the PyTorch/CUDA port of emosaic_tpu.

Runs the default `mosaic` render path (tile analysis, the exact-L1 match
through the mode-1 LUT or the argmin kernel, the composite, the tint and
the PNG), `--randomize`, and the no-repeat renders (`--no-repeat`, with
and without `--greedy`: exact top-k scorers, the adaptive certified
scorer, the greedy assignment) on an NVIDIA GPU, with hand-written CUDA
kernels under `csrc/` for the L1 argmin, the tile composite and the
shortlist rescore, and the C++ greedy engine built at first use.
`emosaic_tpu` stays the reference that this package is tested against.

This file imports nothing: tile-prep workers re-import the package in
spawned processes and must stay light.
"""

__version__ = "0.1.0"
