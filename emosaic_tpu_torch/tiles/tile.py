"""Tile record (reference: src/mosaic/tiles/tile.rs).

Equality/hash are on (idx, flipped) only, like tile.rs:18-29. `colors` is a
[N, 3] uint8 palette (None in random mode, which needs no analysis —
main.rs:414-435).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Tile:
    idx: int  # 1-based (u16 in the reference; unbounded here)
    colors: np.ndarray | None = None  # [N, 3] uint8
    flipped: bool = False
    date_taken: str | None = None

    def __eq__(self, other):
        return (
            isinstance(other, Tile)
            and self.idx == other.idx
            and self.flipped == other.flipped
        )

    def __hash__(self):
        return hash((self.idx, self.flipped))

    @property
    def item(self) -> int:
        """Signed item id: -idx when flipped (tileset.rs:131-143)."""
        return -self.idx if self.flipped else self.idx

    def coords(self) -> np.ndarray:
        """Flattened [3N] search coordinates, flip-aware (tile.rs:104-120)."""
        if self.colors is None:
            raise ValueError("tile has no analysis colors")
        c = np.asarray(self.colors, dtype=np.uint8)
        if self.flipped:
            n = c.shape[0]
            dim = int(np.sqrt(n))
            c = c.reshape(dim, dim, 3)[:, ::-1, :].reshape(n, 3)
        return c.reshape(-1)
