"""TileSet container (reference: src/mosaic/tiles/tileset.rs).

TPU-first representation: palettes live in one dense `[T, N, 3]` uint8
array (the device search matrix is derived from it via
`ops.distance.build_library`), not per-tile objects. Per-tile metadata
(paths, EXIF dates) stays host-side.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from emosaic_tpu_torch.tiles.tile import Tile


@dataclass
class TileSet:
    """Tiles + parallel paths vec + optional in-memory images
    (tileset.rs:22-26)."""

    palettes: np.ndarray | None  # [T, N, 3] uint8; None for random mode
    paths: list[Path]
    dates: list[str | None] = field(default_factory=list)
    images: dict[int, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if not self.dates:
            self.dates = [None] * len(self.paths)
        if self.palettes is not None:
            self.palettes = np.asarray(self.palettes, dtype=np.uint8)
            if len(self.palettes) != len(self.paths):
                raise ValueError("palettes/paths length mismatch")

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def n_cells(self) -> int:
        if self.palettes is None:
            raise ValueError("random-mode tile set has no analysis")
        return self.palettes.shape[1]

    # -- tile accessors (tileset.rs:131-171) --------------------------------

    def get_tile(self, item: int) -> Tile:
        """Signed 1-based item id -> Tile; negative = flipped
        (tileset.rs:131-143)."""
        idx = abs(item)
        if not 1 <= idx <= len(self.paths):
            raise IndexError(f"tile {item} not found")
        return Tile(
            idx=idx,
            colors=None if self.palettes is None else self.palettes[idx - 1],
            flipped=item < 0,
            date_taken=self.dates[idx - 1],
        )

    def get_path(self, tile_or_item) -> Path:
        idx = tile_or_item.idx if isinstance(tile_or_item, Tile) else abs(tile_or_item)
        return self.paths[idx - 1]

    def get_image(self, tile: Tile, tile_size: int) -> np.ndarray:
        """Tile image, flip-aware. Like tileset.rs:146-161 (which hardcodes
        crop=True at render time regardless of --crop — quirk preserved)."""
        from emosaic_tpu_torch.io.prep import prepare_tile

        img = self.images.get(tile.idx)
        if img is None:
            img = prepare_tile(self.get_path(tile), tile_size, crop=True)
        return img[:, ::-1, :] if tile.flipped else img

    def set_image(self, idx: int, image: np.ndarray) -> None:
        self.images[idx] = np.asarray(image, dtype=np.uint8)

    def random_tile(self, rng: random.Random | None = None) -> Tile:
        """Uniformly random tile (tileset.rs:93-97); explicit RNG instead of
        the reference's unseeded thread_rng (SURVEY.md 'randomness parity')."""
        r = rng if rng is not None else random
        return self.get_tile(r.randrange(len(self.paths)) + 1)

    # -- builders ------------------------------------------------------------

    @staticmethod
    def from_tiles(
        palettes, paths, dates=None, images=None
    ) -> "TileSet":
        return TileSet(
            palettes=palettes,
            paths=[Path(p) for p in paths],
            dates=list(dates) if dates else [],
            images=dict(images) if images else {},
        )

    @staticmethod
    def from_arrays(palettes, paths, dates=None) -> "TileSet":
        """A tile set from numpy palettes [T, N, 3] uint8 and their paths,
        for callers that hold the analysis in memory (no files are read)."""
        return TileSet(
            palettes=np.asarray(palettes, dtype=np.uint8),
            paths=[Path(p) for p in paths],
            dates=list(dates) if dates else [],
        )

    def image_stack(self, tile_size: int, progress=None) -> np.ndarray:
        """Dense [T, ts, ts, 3] uint8 stack of prepared tile images for the
        device-side composite gather (replaces per-block disk reads,
        tileset.rs:146-161)."""
        from emosaic_tpu_torch.io.prep import prepare_tile

        out = np.empty((len(self.paths), tile_size, tile_size, 3), dtype=np.uint8)
        for i, path in enumerate(self.paths):
            img = self.images.get(i + 1)
            if img is None or img.shape[0] != tile_size:
                img = prepare_tile(path, tile_size, crop=True)
            out[i] = img
            if progress is not None:
                progress(i + 1, len(self.paths))
        return out
