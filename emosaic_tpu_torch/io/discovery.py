"""Recursive image discovery (reference: src/mosaic/image.rs:7-23).

Extension matching is *case-sensitive* like the reference (hence its
Makefile passes jpg/JPG/jpeg/JPEG — Makefile:80-83, SURVEY.md quirks).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Iterable


def find_images(
    root: str | os.PathLike,
    predicate: Callable[[str], bool] | Iterable[str],
) -> list[Path]:
    """Walk `root` recursively, returning files whose extension passes.

    Args:
      root: directory to walk.
      predicate: either a callable taking the extension (without dot) or an
        iterable of accepted extensions (case-sensitive).

    Returns:
      Paths in a deterministic (sorted) order. The reference's iterative
      walk order is filesystem-dependent; we sort for reproducibility —
      tile indices are assigned from this order (main.rs:786-794).
    """
    root = Path(root)
    if not callable(predicate):
        exts = set(predicate)
        predicate = exts.__contains__
    out: list[Path] = []
    stack = [root]
    try:
        seen_dirs = {root.resolve()}
    except OSError:
        seen_dirs = set()
    while stack:
        d = stack.pop()
        try:
            # the final result is sorted below; no need to sort the walk
            entries = list(d.iterdir())
        except OSError:
            continue
        for p in entries:
            if p.is_dir():
                # directory-symlink cycles would re-collect every image
                # per spelling until ELOOP (the reference's read_dir walk
                # shares the hazard); dedupe on the resolved path —
                # output-identical for acyclic trees (review r4)
                try:
                    rp = p.resolve()
                except OSError:
                    continue
                if rp not in seen_dirs:
                    seen_dirs.add(rp)
                    stack.append(p)
            elif p.is_file():
                ext = p.suffix[1:] if p.suffix else ""
                if ext and predicate(ext):
                    out.append(p)
    return sorted(out)
