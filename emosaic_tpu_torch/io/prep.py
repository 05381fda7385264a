"""Tile preparation pipeline (reference: src/mosaic/tiles/utils.rs:46-196).

Per image: content-hash cache lookup -> decode -> white-border trim ->
optional center square crop -> Lanczos resize to tile_size^2 -> EXIF
orientation rotate -> save to cache.

Exact-parity semantics preserved:
- Cache key: md5 of file bytes; path
  `<cache_dir>/mosaic/{md5}[_cropped].{tile_size}.jpg` (utils.rs:69-78).
  The cache stores *JPEG* (lossy) like the reference — renders read tile
  pixels through this cache (tileset.rs:146-161), so composited tiles are
  JPEG-roundtripped on cache hits in both implementations.
- White = all channels > 240 (utils.rs:94).
- Boundary = most common per-row/col first/last non-white coordinate
  (utils.rs:108-161); all-white rows/cols contribute sentinel w/0 and are
  filtered (utils.rs:158-161). `most_common_value` ties are
  HashMap-order-dependent in the reference; here deterministic: highest
  count, then smallest value.
- Trim rectangle width/height is `last - first` — the last non-white
  column/row itself is excluded (quirk preserved; utils.rs:166-175).
- Undersized images (w or h < tile_size) are rejected (utils.rs:99-106).
- EXIF rotation is applied *after* resize, 8 orientation cases
  (utils.rs:248-264; note image-crate rotate90 is clockwise = PIL
  ROTATE_270).

Deviation (recorded): a fully-white image panics the reference
(utils.rs:163-164 assert); here it raises ImageError and is collected as a
per-image error like other failures.

Beyond-parity opt-in (`--fast-prep` / EMOSAIC_FAST_PREP=1, docs/PARITY.md):
JPEG sources decode at the largest libjpeg DCT scale that keeps both sides
>= 4*tile_size (PIL draft mode), and trim/crop run in the scaled space —
measured 4.4x on 6 MP photos at <=1 LSB output difference. If the trimmed
crop falls under a 2*tile_size supersampling floor the image is redone at
full resolution, so quality never degrades below the exact path's. All
caches (content-hash, analysis, stack) carry a `_fast` tag: exact and fast
runs never read each other's artifacts. The DEFAULT path is untouched —
full-resolution decode, exact reference trim semantics.
"""

from __future__ import annotations

import hashlib
import io
import os
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from emosaic_tpu_torch.errors import ImageError
from emosaic_tpu_torch.io.exif import date_of, get_exif_date, orientation_of

if TYPE_CHECKING:
    from PIL import Image

#: fast-prep draft target per side, in tile_sizes: decode at the largest
#: DCT scale keeping both dims >= this many tile_sizes (>=4x supersampling
#: headroom before trim/crop)
_FAST_MARGIN = 4
#: minimum supersampling of the trimmed crop; below it the fast path redoes
#: the image at full resolution so Lanczos never upsamples low-detail input
_FAST_FLOOR = 2


def _pil():
    """Pillow, imported only where images are decoded or encoded, so the
    render path imports without it."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # gigapixel sources are expected
    return Image


def fast_prep_enabled() -> bool:
    """Opt-in DCT-scaled JPEG decode (module docstring). Env-var backed so
    the flag reaches spawn-context prep workers without signature churn."""
    return os.environ.get("EMOSAIC_FAST_PREP", "") == "1"


def cache_dir() -> Path:
    """`~/.cache/mosaic` (or $XDG_CACHE_HOME/mosaic), like dirs::cache_dir
    (utils.rs:73, main.rs:367-376)."""
    base = os.environ.get("XDG_CACHE_HOME")
    root = Path(base) if base else Path.home() / ".cache"
    return root / "mosaic"


def most_common_value(values) -> int:
    """Most frequent value; ties -> smallest; empty -> 0 (utils.rs:266-277)."""
    values = np.asarray(list(values), dtype=np.int64)
    if values.size == 0:
        return 0
    uniq, counts = np.unique(values, return_counts=True)
    return int(uniq[np.argmax(counts)])


def trim_bounds(img: np.ndarray) -> tuple[int, int, int, int]:
    """White-border trim rectangle (left, top, width, height).

    Vectorized equivalent of the reference's per-row/col scans
    (utils.rs:108-161). Raises ImageError-style ValueError when the most
    common boundaries are inverted (all/mostly white image).
    """
    h, w = img.shape[0], img.shape[1]
    nonwhite = ~(img > 240).all(axis=2)  # [h, w]

    row_has = nonwhite.any(axis=1)
    from_left = np.where(row_has, nonwhite.argmax(axis=1), w)
    from_right = np.where(row_has, w - 1 - nonwhite[:, ::-1].argmax(axis=1), 0)
    col_has = nonwhite.any(axis=0)
    from_top = np.where(col_has, nonwhite.argmax(axis=0), h)
    from_bottom = np.where(col_has, h - 1 - nonwhite[::-1, :].argmax(axis=0), 0)

    first_col = most_common_value(from_left[from_left != w])
    last_col = most_common_value(from_right[from_right != 0])
    first_row = most_common_value(from_top[from_top != h])
    last_row = most_common_value(from_bottom[from_bottom != 0])

    if not (first_col < last_col and first_row < last_row):
        raise ValueError("image trims to nothing (all white?)")
    return first_col, first_row, last_col - first_col, last_row - first_row


# EXIF orientation -> PIL transpose op. The reference composes image-crate
# clockwise rotations (utils.rs:248-264); these are the standard equivalent
# PIL transposes (rotate90 CW == PIL ROTATE_270).
_ORIENT_TO_TRANSPOSE = {
    2: "FLIP_LEFT_RIGHT",
    3: "ROTATE_180",
    4: "FLIP_TOP_BOTTOM",
    5: "TRANSPOSE",
    6: "ROTATE_270",
    7: "TRANSVERSE",
    8: "ROTATE_90",
}


def apply_orientation(im: Image.Image, orientation: int) -> Image.Image:
    op = _ORIENT_TO_TRANSPOSE.get(orientation)
    if op is None:
        return im
    return im.transpose(getattr(_pil().Transpose, op))


def _trim_crop(rgb: Image.Image, crop: bool) -> tuple[Image.Image, int]:
    """White-trim (+ optional centered square crop) of a decoded image;
    returns (cropped image, min crop dimension). Raises ValueError for
    all/mostly-white images (trim_bounds)."""
    arr = np.asarray(rgb, dtype=np.uint8)
    # the native AVX2 scan when the engine builds (parity-tested in
    # tests/test_torch_native.py); the numpy scan is the oracle/fallback
    from emosaic_tpu_torch import native

    trim = native.trim_bounds if native.available() else trim_bounds
    left, top, tw, th = trim(arr)
    if crop:
        # largest centered square inside the trimmed region (utils.rs:176-187)
        size = min(tw, th)
        left += (tw - size) // 2
        top += (th - size) // 2
        tw = th = size
    return rgb.crop((left, top, left + tw, top + th)), min(tw, th)


def _prepare(
    path: Path, tile_size: int, crop: bool, want_date: bool
) -> tuple[np.ndarray, str | None]:
    """Single-open prep core: the file is read and decoded once; EXIF
    orientation/date come from the same open image."""
    Image = _pil()
    try:
        data = path.read_bytes()
    except OSError as e:
        raise ImageError(path, str(e)) from e
    digest = hashlib.md5(data).hexdigest()
    fast = fast_prep_enabled()
    tag = ("_cropped" if crop else "") + ("_fast" if fast else "")
    cpath = cache_dir() / f"{digest}{tag}.{tile_size}.jpg"

    if cpath.exists():
        try:
            with Image.open(cpath) as im:
                cached = np.asarray(im.convert("RGB"), dtype=np.uint8)
            if cached.shape == (tile_size, tile_size, 3):
                date = get_exif_date(path) if want_date else None
                return cached, date
            # wrong-dimension cache entry (corrupt / foreign writer in the
            # shared reference-compatible dir): regenerate instead of
            # poisoning the stack build (review r4)
        except Exception:
            pass  # fall through to regeneration, like the or_else chain

    try:
        with Image.open(io.BytesIO(data)) as im:
            date = date_of(im) if want_date else None
            orientation = orientation_of(im)
            w, h = im.size  # pre-draft dims: the size gate uses the original
            drafted = False
            if fast:
                # largest DCT scale keeping both dims >= margin*tile_size;
                # a no-op for non-JPEG decoders and already-small images
                im.draft("RGB", (_FAST_MARGIN * tile_size,) * 2)
                drafted = im.size != (w, h)
            rgb = im.convert("RGB")
    except Exception as e:
        raise ImageError(path, str(e)) from e

    if w < tile_size or h < tile_size:
        raise ImageError(path, f"image {w}x{h} smaller than tile size {tile_size}")

    try:
        try:
            cropped, mindim = _trim_crop(rgb, crop)
            redo = drafted and mindim < _FAST_FLOOR * tile_size
        except ValueError:
            # drafted decode averaged faint/thin content above the white
            # threshold ("trims to nothing") — the exact path may still
            # keep this image, so retry full-res before rejecting
            if not drafted:
                raise
            redo = True
        if redo:
            # the trimmed crop fell under the supersampling floor in scaled
            # space (or drafted trim rejected the image): redo at full
            # resolution (rare — only heavily-trimmed images; quality then
            # equals the exact path's)
            with Image.open(io.BytesIO(data)) as im:
                rgb = im.convert("RGB")
            cropped, mindim = _trim_crop(rgb, crop)
    except ValueError as e:
        raise ImageError(path, str(e)) from e

    resized = cropped.resize((tile_size, tile_size), Image.LANCZOS)
    oriented = apply_orientation(resized, orientation)

    cpath.parent.mkdir(parents=True, exist_ok=True)
    try:
        # atomic write: parallel prep workers may race on identical
        # content (same md5); a rename never exposes a partial file
        tmp = cpath.with_suffix(f".{os.getpid()}.tmp")
        oriented.save(tmp, format="JPEG")
        os.replace(tmp, cpath)
    except OSError as e:
        raise ImageError(path, f"failed to write cache: {e}") from e
    # Deviation (recorded): return the JPEG-roundtripped cache bytes rather
    # than the pre-encode image. The reference returns pre-encode pixels on
    # a cache miss but roundtripped pixels ever after (utils.rs:86-194) —
    # making first-run outputs differ from every later run; here all runs
    # see identical pixels.
    with Image.open(cpath) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8), date


def prepare_tile(
    path: str | os.PathLike, tile_size: int, crop: bool
) -> np.ndarray:
    """Prepare one tile image; returns [tile_size, tile_size, 3] uint8.

    Reference: prepare_tile (utils.rs:63-196).
    """
    img, _ = _prepare(Path(path), tile_size, crop, want_date=False)
    return img


def prepare_tile_with_date(
    path: str | os.PathLike, tile_size: int, crop: bool
) -> tuple[np.ndarray, str | None]:
    """prepare_tile + EXIF date (utils.rs:46-60)."""
    return _prepare(Path(path), tile_size, crop, want_date=True)


def prep_worker(args) -> tuple[str, "np.ndarray | None", str | None, str | None]:
    """Process-pool entry for parallel tile prep (the rayon `par_iter`
    analogue, main.rs:760-766). Lives here so spawn workers import only
    this torch-free module. Never raises: returns
    (path, image|None, date|None, error_message|None)."""
    path, tile_size, crop = args
    try:
        img, date = prepare_tile_with_date(path, tile_size, crop)
        return (str(path), img, date, None)
    except ImageError as e:
        return (str(path), None, None, str(e.error))
    except Exception as e:  # defensive: a worker crash must not kill the run
        return (str(path), None, None, str(e))
