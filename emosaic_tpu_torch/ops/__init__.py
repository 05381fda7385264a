"""Device compute in torch: analysis, L1 matching, LUT, composite and tint.

The CUDA kernels are built from `csrc/` by `ops/_kernels.py` at first use."""
