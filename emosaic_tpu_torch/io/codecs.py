"""Streaming, parallel PNG encoder for gigapixel outputs.

The reference assembles the full output in RAM and PNG-encodes it in one
shot through the single-threaded `image` crate (rendering.rs:91-94,
main.rs:482-490) — impossible at gigapixel scale (SURVEY.md §5
"long-context": W*H*ts^2*3 bytes) and encode-bound long before that
(SURVEY.md §7 hard parts: "PNG throughput for gigapixel outputs").

Here the device composes the mosaic in horizontal bands
(ops.composite.iter_bands) and this encoder writes them into a single
PNG whose zlib stream is produced by a pool of workers:

- Scanlines are grouped into fixed-size segments (~1 MiB of filtered
  bytes, whole scanlines). Segmentation depends only on the image width,
  never on band chunking or worker count, so output bytes are
  deterministic.
- Each worker applies the PNG scanline filter (None/Sub/Up, exact mod-256
  semantics) and compresses its segment as an *independent raw-deflate
  stream ended with Z_FULL_FLUSH* — byte-aligned and with no BFINAL bit,
  so segments concatenate into one valid zlib stream (the pigz framing).
- The writer emits segments as IDAT chunks in order and finishes the
  stream with an empty fixed-Huffman final block (\\x03\\x00) plus the
  adler32 of all filtered bytes, folded together with zlib's
  adler32_combine recurrence (O(1) per segment, no serial re-hash).

CPython's zlib releases the GIL while (de)compressing, so thread-level
parallelism reaches C speed per core; peak host memory stays bounded at
one band plus ~2*workers in-flight segments. `compress_level=0` writes
stored blocks (fastest, no compression — the filter is forced to None
since filtering only helps compression); the default Sub filter improves
photographic compression ~11 points over unfiltered at negligible cost.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_SEG_TARGET = 1 << 20  # ~1 MiB of filtered bytes per compression segment
_ADLER_BASE = 65521

_FILTERS = {"none": 0, "sub": 1, "up": 2, 0: 0, 1: 1, 2: 2}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """zlib's adler32_combine: adler of concat(A, B) from adler(A),
    adler(B), len(B). Exact port of the zlib recurrence."""
    rem = len2 % _ADLER_BASE
    sum1 = ad1 & 0xFFFF
    sum2 = (rem * sum1) % _ADLER_BASE
    sum1 += (ad2 & 0xFFFF) + _ADLER_BASE - 1
    sum2 += (
        ((ad1 >> 16) & 0xFFFF)
        + ((ad2 >> 16) & 0xFFFF)
        + _ADLER_BASE
        - rem
    )
    if sum1 >= _ADLER_BASE:
        sum1 -= _ADLER_BASE
    if sum1 >= _ADLER_BASE:
        sum1 -= _ADLER_BASE
    if sum2 >= 2 * _ADLER_BASE:
        sum2 -= 2 * _ADLER_BASE
    if sum2 >= _ADLER_BASE:
        sum2 -= _ADLER_BASE
    return sum1 | (sum2 << 16)


def _compress_segment(
    rows: np.ndarray,
    prev_row: np.ndarray | None,
    level: int,
    ftype: int,
) -> tuple[bytes, int, int]:
    """Filter + raw-deflate one segment of whole scanlines.

    rows: [h, width*3] u8 (raw pixels); prev_row: [width*3] u8 raw
    scanline directly above rows[0] (for the Up filter), or None at the
    top of the image. Returns (deflate bytes ending at a byte-aligned
    non-final block, adler32 of the filtered bytes, filtered byte count).
    """
    h, rowbytes = rows.shape
    filtered = np.empty((h, 1 + rowbytes), dtype=np.uint8)
    filtered[:, 0] = ftype
    if ftype == 0:
        filtered[:, 1:] = rows
    elif ftype == 1:  # Sub: raw[x] - raw[x-3], mod 256 (bpp=3)
        filtered[:, 1:4] = rows[:, :3]
        filtered[:, 4:] = rows[:, 3:] - rows[:, :-3]
    elif ftype == 2:  # Up: raw[x] - above[x], mod 256
        filtered[:, 1:] = rows
        if prev_row is not None:
            filtered[0, 1:] -= prev_row
        filtered[1:, 1:] -= rows[:-1]
    else:  # pragma: no cover - guarded by _FILTERS
        raise ValueError(f"unsupported PNG filter {ftype}")
    raw = filtered.tobytes()
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    out = z.compress(raw) + z.flush(zlib.Z_FULL_FLUSH)
    return out, zlib.adler32(raw), len(raw)


class StreamingPNGWriter:
    """Write an RGB8 PNG incrementally, band by band (top to bottom).

    Output bytes are a pure function of (pixels, width, height,
    compress_level, filter_type) — band chunking and `workers` only
    affect wall time and memory.
    """

    def __init__(
        self,
        path,
        width: int,
        height: int,
        compress_level: int = 1,
        filter_type: str | int = "sub",
        workers: int | None = None,
    ):
        """`path` is a filesystem path, or any object with a `write`
        method (e.g. an HTTP chunked-response wrapper — the serve module
        streams gigapixel PNGs without materializing them); file-like
        sinks are flushed but not closed."""
        self.width = width
        self.height = height
        self._level = compress_level
        try:
            self._ftype = _FILTERS[filter_type]
        except KeyError:
            names = sorted(k for k in _FILTERS if isinstance(k, str))
            raise ValueError(
                f"filter_type must be one of {names} (or 0/1/2), "
                f"got {filter_type!r}"
            ) from None
        if compress_level == 0:
            self._ftype = 0  # stored blocks gain nothing from filtering
        self._rowbytes = width * 3
        self._seg_rows = max(1, _SEG_TARGET // (1 + self._rowbytes))
        self._rows_written = 0  # rows accepted from the caller
        self._buf: list[np.ndarray] = []  # pending raw rows, [h, rowbytes]
        self._buf_rows = 0
        self._prev_row: np.ndarray | None = None  # raw row above the buffer
        self._adler = 1
        self._wrote_header = False

        if workers is None:
            workers = min(16, os.cpu_count() or 1)
        self._pool = (
            ThreadPoolExecutor(max_workers=workers) if workers > 1 else None
        )
        self._max_pending = 2 * workers
        self._pending: list = []  # futures (or ready tuples), in order

        if hasattr(path, "write"):
            self._f = path
            self._owns_f = False
        else:
            self._f = open(path, "wb")
            self._owns_f = True
        self._closed = False
        self._f.write(_PNG_SIG)
        ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
        self._f.write(_chunk(b"IHDR", ihdr))

    # -- segment plumbing ---------------------------------------------------

    def _submit(self, rows: np.ndarray) -> None:
        prev = self._prev_row
        self._prev_row = rows[-1].copy() if self._ftype == 2 else None
        if self._pool is not None:
            if rows.base is not None:
                # never hand a view of the caller's band to a worker: the
                # caller may legally reuse its buffer once write_band
                # returns, while the thread compresses later
                rows = rows.copy()
            fut = self._pool.submit(
                _compress_segment, rows, prev, self._level, self._ftype
            )
            self._pending.append(fut)
            while len(self._pending) > self._max_pending:
                self._write_segment(self._pending.pop(0).result())
        else:
            self._write_segment(
                _compress_segment(rows, prev, self._level, self._ftype)
            )

    def _write_segment(self, seg: tuple[bytes, int, int]) -> None:
        data, adler, nbytes = seg
        if not self._wrote_header:
            data = b"\x78\x01" + data  # zlib header (CM=8, no dict)
            self._wrote_header = True
        self._adler = adler32_combine(self._adler, adler, nbytes)
        self._f.write(_chunk(b"IDAT", data))

    def _drain(self) -> None:
        for fut in self._pending:
            self._write_segment(fut.result())
        self._pending.clear()

    def _flush_buffer(self, final: bool) -> None:
        """Cut whole-scanline segments of exactly _seg_rows rows; on final,
        also emit the remainder."""
        while self._buf_rows >= self._seg_rows or (final and self._buf_rows):
            take = min(self._seg_rows, self._buf_rows)
            parts, got = [], 0
            while got < take:
                head = self._buf[0]
                need = take - got
                if head.shape[0] <= need:
                    parts.append(head)
                    self._buf.pop(0)
                    got += head.shape[0]
                else:
                    parts.append(head[:need])
                    self._buf[0] = head[need:]
                    got += need
            self._buf_rows -= take
            seg = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._submit(np.ascontiguousarray(seg))

    # -- public API ---------------------------------------------------------

    def write_band(self, band: np.ndarray) -> None:
        """Append `[h, width, 3]` uint8 rows."""
        band = np.ascontiguousarray(band, dtype=np.uint8)
        if band.ndim != 3 or band.shape[1] != self.width or band.shape[2] != 3:
            raise ValueError(f"band shape {band.shape} != (h, {self.width}, 3)")
        if self._rows_written + band.shape[0] > self.height:
            raise ValueError("too many rows")
        self._rows_written += band.shape[0]
        self._buf.append(band.reshape(band.shape[0], self._rowbytes))
        self._buf_rows += band.shape[0]
        self._flush_buffer(final=False)
        # rows retained past this call must not alias the caller's band
        # (callers may reuse their buffer between write_band calls)
        self._buf = [a if a.base is None else a.copy() for a in self._buf]

    def _release(self) -> None:
        self._closed = True
        if self._owns_f:
            self._f.close()
        else:
            try:
                self._f.flush()
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        if self._closed or (self._owns_f and self._f.closed):
            return
        try:
            if self._rows_written != self.height:
                raise ValueError(
                    f"wrote {self._rows_written} rows, expected {self.height}"
                )
            self._flush_buffer(final=True)
            self._drain()
            tail = b""
            if not self._wrote_header:  # zero-pixel image: header-only stream
                tail = b"\x78\x01"
            # empty final fixed-Huffman block + adler32 of the filtered bytes
            tail += b"\x03\x00" + struct.pack(">I", self._adler)
            self._f.write(_chunk(b"IDAT", tail))
            self._f.write(_chunk(b"IEND", b""))
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
            self._release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
            self._release()
        return False
