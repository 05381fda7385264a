"""Persistent analysis cache `.emosaic_{N}to1[_cropped]` (main.rs:597-661).

Name, location (inside the tiles dir), and invalidation semantics match the
reference: `--force` skips the read and rewrites; on load, entries whose
files no longer exist or no longer match the extension set are dropped and
the surviving tiles are renumbered sequentially from 1 (main.rs:626-653).
The payload format is npz (palettes as one dense array) instead of bincode —
the cache concept and lifecycle are the parity surface, not the bytes
(SURVEY.md section 5 "checkpoint/resume").
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np

from emosaic_tpu_torch.io.prep import fast_prep_enabled
from emosaic_tpu_torch.tiles.tileset import TileSet

_MAGIC = "emosaic_tpu-analysis-v1"


def analysis_cache_path(tiles_dir: str | os.PathLike, n_cells: int, crop: bool) -> Path:
    """`<tiles_dir>/.emosaic_{N}to1[_cropped]` (main.rs:597-601). Under
    --fast-prep a `_fast` tag keeps analyses of DCT-scaled tiles separate
    from exact ones (see io/prep.py module docstring)."""
    fast = "_fast" if fast_prep_enabled() else ""
    return Path(tiles_dir) / f".emosaic_{n_cells}to1{'_cropped' if crop else ''}{fast}"


def _atomic_write(path: Path, data: bytes) -> None:
    """tmp + rename: concurrent writers (parallel CLI invocations, or the
    ranks of a multi-controller run on one host) each land a complete
    file instead of tearing each other — same discipline as the prep
    cache (io/prep.py)."""
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def save_tileset_cache(path: str | os.PathLike, ts: TileSet) -> None:
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        magic=np.array(_MAGIC),
        palettes=ts.palettes,
        paths=np.array([str(p) for p in ts.paths]),
        dates=np.array([d if d is not None else "" for d in ts.dates]),
    )
    _atomic_write(Path(path), buf.getvalue())


def load_tileset_cache(
    path: str | os.PathLike, extensions: set[str]
) -> TileSet | None:
    """Load + revalidate + renumber; None on any read/parse failure
    (the reference treats a corrupt cache as a miss, main.rs:622-623)."""
    path = Path(path)
    try:
        data = np.load(io.BytesIO(path.read_bytes()), allow_pickle=False)
        if str(data["magic"]) != _MAGIC:
            return None
        palettes = data["palettes"]
        paths = [Path(p) for p in data["paths"]]
        dates = [d if d else None for d in data["dates"]]
    except Exception:
        return None
    if len(paths) != len(palettes) or len(dates) != len(paths):
        return None
    # Revalidate: keep entries whose file exists and extension still matches
    # (main.rs:626-639); renumbering is implicit in the dense representation.
    keep = [
        i
        for i, p in enumerate(paths)
        if p.suffix[1:] in extensions and p.exists()
    ]
    if not keep:
        return TileSet(palettes=palettes[:0], paths=[], dates=[])
    return TileSet(
        palettes=palettes[keep],
        paths=[paths[i] for i in keep],
        dates=[dates[i] for i in keep],
    )


def stack_cache_path(tiles_dir: str | os.PathLike, tile_size: int) -> Path:
    """Prepared-tile *stack* cache (rebuild-specific extension): the device
    composite wants a dense [T, ts, ts, 3] array; rebuilding it from 100k
    per-tile JPEGs on every run would bottleneck on host decode."""
    fast = "_fast" if fast_prep_enabled() else ""
    return Path(tiles_dir) / f".emosaic_stack_{tile_size}{fast}"


def save_stack_cache(path: str | os.PathLike, paths: list[Path], stack: np.ndarray):
    # write straight to the tmp file: a BytesIO staging copy doubles peak
    # host RSS at exactly the multi-GB scale this cache exists for
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(
            f,
            magic=np.array(_MAGIC),
            paths=np.array([str(p) for p in paths]),
            stack=stack,
        )
    os.replace(tmp, path)


def load_stack_cache(
    path: str | os.PathLike, expected_paths: list[Path]
) -> np.ndarray | None:
    path = Path(path)
    try:
        # np.load on the path reads members lazily — no whole-file
        # read_bytes() copy next to the multi-GB stack array
        data = np.load(path, allow_pickle=False)
        if str(data["magic"]) != _MAGIC:
            return None
        paths = [Path(p) for p in data["paths"]]
        if paths != list(expected_paths):
            return None
        return data["stack"]
    except Exception:
        return None
