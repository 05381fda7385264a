"""Render statistics (reference: src/mosaic/stats.rs).

Collects per-placement (position -> tile, distance) records, prints the
summary (stats.rs:87-139), and renders the grayscale match-quality heatmap
(stats.rs:154-195).

Array-backed: a gigapixel render places 16.7M tiles; per-entry Python
objects cost ~100s and gigabytes (measured: 25s / 2.7 GB at 4.2M). Bulk
construction is `from_grid` (vectorized); `push_tile` remains for the
incremental/test path; the `tiles` dict view is materialized lazily for
the HTML widget (which is only sensible at small sizes anyway).

Coordinate-space quirk preserved: `render_nto1` records *source-pixel*
coords (rendering.rs:211-214) while the global-greedy no-repeat renderer
records *output-pixel* coords (rendering.rs:357-364); the heatmap and the
widget geometry only line up for the latter (SURVEY.md section 3.5).

Determinism improvement over the reference: top-10/worst-10 tie order is
HashMap-iteration-dependent there; here ties break by path / position.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np


@dataclass
class MosaicConfig:
    """Generation settings snapshot (stats.rs:10-21)."""

    tile_size: int
    mode: str
    no_repeat: bool
    greedy: bool
    crop: bool
    tint_opacity: float
    downsample: int
    randomize: float | None
    tiles_dir: str
    title: str


@dataclass
class StatsEntry:
    idx: int
    flipped: bool
    date_taken: str | None
    distance: int


class RenderStats:
    """Maps placement (x, y) -> (tile, distance) (stats.rs:28-31),
    stored as parallel arrays."""

    def __init__(self):
        self._xs: list[int] = []
        self._ys: list[int] = []
        self._items: list[int] = []  # signed item ids
        self._dists: list[int] = []
        self._dates: list[str | None] = []
        self._arrays = None  # (xs, ys, items, dists) numpy cache
        self._dates_arr = None
        self._dict = None

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_grid(
        items_grid: np.ndarray,
        dists_grid: np.ndarray,
        x_scale: int,
        y_scale: int,
        tile_set,
    ) -> "RenderStats":
        """Vectorized bulk construction from a [nby, nbx] signed item grid.

        Placement keys are (bx * x_scale, by * y_scale) — source coords for
        render_nto1 (scale = dim), output coords for the no-repeat renderer
        (scale = tile_size). item 0 (unassigned) entries are skipped, like
        the reference's skipped blocks.
        """
        s = RenderStats()
        nby, nbx = items_grid.shape
        items = np.asarray(items_grid, dtype=np.int64).reshape(-1)
        dists = np.asarray(dists_grid, dtype=np.int64).reshape(-1)
        keep = items != 0
        by, bx = np.divmod(np.arange(nby * nbx)[keep], nbx)
        s._set_arrays(
            bx.astype(np.int64) * x_scale,
            by.astype(np.int64) * y_scale,
            items[keep],
            dists[keep],
            tile_set,
        )
        return s

    def _set_arrays(self, xs, ys, items, dists, tile_set):
        self._arrays = (xs, ys, items, dists)
        dates = np.asarray(
            [d if d is not None else "" for d in tile_set.dates], dtype=object
        )
        idx = np.abs(items) - 1
        self._dates_arr = (
            dates[idx] if len(dates) else np.full(len(items), "", dtype=object)
        )

    def push_tile(self, x: int, y: int, tile, distance: int) -> None:
        self._invalidate()
        self._xs.append(int(x))
        self._ys.append(int(y))
        self._items.append(tile.item)
        self._dists.append(int(distance))
        self._dates.append(tile.date_taken)

    def _invalidate(self):
        if self._arrays is not None:
            xs, ys, items, dists = self._arrays
            self._xs = list(map(int, xs))
            self._ys = list(map(int, ys))
            self._items = list(map(int, items))
            self._dists = list(map(int, dists))
            self._dates = list(self._dates_arr)
            self._arrays = None
            self._dates_arr = None
        self._dict = None

    def _get_arrays(self):
        if self._arrays is None:
            xs = np.asarray(self._xs, dtype=np.int64)
            ys = np.asarray(self._ys, dtype=np.int64)
            items = np.asarray(self._items, dtype=np.int64)
            dists = np.asarray(self._dists, dtype=np.int64)
            dates = np.asarray(
                [d if d else "" for d in self._dates], dtype=object
            )
            # later pushes to the same (x, y) overwrite (dict semantics)
            key = xs * (2**32) + ys
            _, last = np.unique(key[::-1], return_index=True)
            sel = np.sort(len(key) - 1 - last)
            return xs[sel], ys[sel], items[sel], dists[sel], dates[sel]
        xs, ys, items, dists = self._arrays
        return xs, ys, items, dists, self._dates_arr

    # -- views ----------------------------------------------------------------

    @property
    def tiles(self) -> dict[tuple[int, int], StatsEntry]:
        """Dict view for the widget/tests (lazy; O(N) objects — avoid on
        gigapixel grids)."""
        if self._dict is None:
            xs, ys, items, dists, dates = self._get_arrays()
            self._dict = {
                (int(x), int(y)): StatsEntry(
                    idx=int(abs(it)),
                    flipped=bool(it < 0),
                    date_taken=(d if d else None),
                    distance=int(dd),
                )
                for x, y, it, dd, d in zip(xs, ys, items, dists, dates)
            }
        return self._dict

    def tile_count(self) -> int:
        xs, *_ = self._get_arrays()
        return len(xs)

    # -- reporting (stats.rs:87-139) -------------------------------------------

    def summarise(self, tile_set, log=lambda *a: print(*a, file=sys.stderr)) -> None:
        xs, ys, items, dists, _ = self._get_arrays()
        if len(xs) == 0:
            log("No tiles recorded in statistics")
            return
        idx0 = np.abs(items) - 1  # 0-based tile index
        counts = np.bincount(idx0, minlength=len(tile_set))
        used = np.nonzero(counts)[0]
        log("Mosaic Statistics:")
        log(f"  Total tiles placed: {len(xs)}")
        log(f"  Unique images used: {len(used)}")
        log(f"  Average color distance: {dists.sum() / len(xs):.3f}")
        log("\nTop 10 most used tiles:")
        order = sorted(used, key=lambda i: (-counts[i], str(tile_set.get_path(int(i) + 1))))
        for n, i in enumerate(order[:10]):
            log(f"  {n + 1}. {tile_set.get_path(int(i) + 1)} ({counts[i]} times)")
        log("\nWorst 10 color matches:")
        worst = np.lexsort((ys, xs, -dists))[:10]
        for n, j in enumerate(worst):
            log(
                f"  {n + 1}. {tile_set.get_path(int(idx0[j]) + 1)} "
                f"(distance: {int(dists[j])})"
            )

    def to_dict(self, tile_set, config=None) -> dict:
        """Machine-readable summary: the same aggregates `summarise`
        prints (stats.rs:87-139) plus the config snapshot — for
        `--stats-json` pipeline consumers (no reference counterpart;
        the reference only writes human-oriented stderr/HTML)."""
        import dataclasses

        xs, ys, items, dists, _ = self._get_arrays()
        out: dict = {"total_tiles": int(len(xs))}
        if len(xs):
            idx0 = np.abs(items) - 1
            counts = np.bincount(idx0, minlength=len(tile_set))
            used = np.nonzero(counts)[0]
            order = sorted(
                used,
                key=lambda i: (-counts[i], str(tile_set.get_path(int(i) + 1))),
            )
            worst = np.lexsort((ys, xs, -dists))[:10]
            out.update(
                unique_images=int(len(used)),
                average_distance=float(dists.sum() / len(xs)),
                max_distance=int(dists.max()),
                top_used=[
                    {
                        "path": str(tile_set.get_path(int(i) + 1)),
                        "count": int(counts[i]),
                    }
                    for i in order[:10]
                ],
                worst_matches=[
                    {
                        "path": str(tile_set.get_path(int(idx0[j]) + 1)),
                        "distance": int(dists[j]),
                        "x": int(xs[j]),
                        "y": int(ys[j]),
                    }
                    for j in worst
                ],
            )
        if config is not None:
            out["config"] = dataclasses.asdict(config)
        return out

    def render(self, tile_size: int) -> np.ndarray:
        """Grayscale heatmap, 1 px per placement, distance normalized to the
        max (stats.rs:154-195). Returns [h, w, 3] uint8."""
        xs, ys, _, dists, _ = self._get_arrays()
        if len(xs) == 0:
            raise ValueError("Cannot render visualization: no tiles recorded")
        if tile_size <= 0:
            raise ValueError("Tile size must be greater than 0")
        max_d = int(dists.max())
        w = int(xs.max()) // tile_size + 1
        h = int(ys.max()) // tile_size + 1
        img = np.zeros((h, w, 3), dtype=np.uint8)
        nd = (dists / max_d * 255.0).astype(np.uint8) if max_d > 0 else np.zeros(
            len(dists), dtype=np.uint8
        )
        img[ys // tile_size, xs // tile_size] = nd[:, None]
        return img
