"""Error types (reference: src/mosaic/error.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass
class ImageError(Exception):
    """A per-image failure, collected (not fatal) during analysis
    (main.rs:759-806)."""

    path: Path
    error: str

    def __str__(self) -> str:
        return f"{self.path}: {self.error}"
