"""Mosaic mode definitions.

The reference exposes modes 1,2,3,4,5,6,8,16,32,64,128 plus `random`
(src/main.rs:112-138). Mode *n* means each source block is an n x n grid of
color cells, i.e. N = n^2 cells and a 3N-dimensional search space
(src/main.rs:400-413: mode 2 -> N=4, mode 128 -> N=16384).
"""

from __future__ import annotations

import enum


class Mode(str, enum.Enum):
    M1 = "1"
    M2 = "2"
    M3 = "3"
    M4 = "4"
    M5 = "5"
    M6 = "6"
    M8 = "8"
    M16 = "16"
    M32 = "32"
    M64 = "64"
    M128 = "128"
    RANDOM = "random"

    @property
    def n_cells(self) -> int:
        """N = dim^2 cells per block (src/main.rs:400-413)."""
        if self is Mode.RANDOM:
            raise ValueError("random mode has no cell grid")
        return int(self.value) ** 2

    @property
    def dim(self) -> int:
        """Block edge length in source pixels (sqrt(N))."""
        if self is Mode.RANDOM:
            raise ValueError("random mode has no cell grid")
        return int(self.value)

    @property
    def label(self) -> str:
        """Human-readable mode string used in MosaicConfig (src/main.rs:688-701)."""
        if self is Mode.RANDOM:
            return "Random"
        d = self.dim
        return f"{d}x{d} (N={d * d})"


#: mode value -> N mapping, mirroring the reference's monomorphization table.
MODE_TO_N = {m.value: m.n_cells for m in Mode if m is not Mode.RANDOM}
