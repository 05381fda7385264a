"""EXIF metadata extraction (reference: src/mosaic/tiles/utils.rs:198-246).

- Orientation tag (1..8, default 1 for missing/invalid values).
- Date from DateTimeOriginal > DateTime > DateTimeDigitized, keeping only
  the `YYYY:MM:DD` part before the first space.

The `*_of(im)` variants read from an already-open PIL image so the prep
pipeline decodes each tile file once (the path-based variants re-open).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from PIL import Image

_TAG_ORIENTATION = 0x0112
_TAG_DATETIME = 0x0132
_TAG_DATETIME_ORIGINAL = 0x9003
_TAG_DATETIME_DIGITIZED = 0x9004


def orientation_of(im: Image.Image) -> int:
    """EXIF orientation 1..8 from an open image; 1 when missing or out of
    range (utils.rs:198-212)."""
    try:
        v = im.getexif().get(_TAG_ORIENTATION)
    except Exception:
        return 1
    if isinstance(v, int) and 1 <= v <= 8:
        return v
    return 1


def get_orientation(path: str | os.PathLike) -> int:
    """EXIF orientation 1..8; 1 when missing or out of range."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            return orientation_of(im)
    except Exception:
        return 1


def date_of(im: Image.Image) -> str | None:
    """EXIF date `YYYY:MM:DD` from an open image (utils.rs:215-246).

    Tag preference order matches the reference: DateTimeOriginal, then
    DateTime, then DateTimeDigitized; the value is truncated at the first
    space and stripped of NULs.
    """
    try:
        exif = im.getexif()
        ifd = {}
        try:
            ifd = exif.get_ifd(0x8769)  # Exif sub-IFD
        except Exception:
            pass
        for tag in (_TAG_DATETIME_ORIGINAL, _TAG_DATETIME, _TAG_DATETIME_DIGITIZED):
            v = ifd.get(tag) if tag in ifd else exif.get(tag)
            if isinstance(v, bytes):
                try:
                    v = v.decode("utf-8")
                except UnicodeDecodeError:
                    continue
            if isinstance(v, str) and v:
                v = v.rstrip("\0")
                sp = v.find(" ")
                return v[:sp] if sp >= 0 else v
    except Exception:
        return None
    return None


def get_exif_date(path: str | os.PathLike) -> str | None:
    """Date string `YYYY:MM:DD` or None (utils.rs:215-246)."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            return date_of(im)
    except Exception:
        return None
