#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`emosaic_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines:

  A  environment: torch/CUDA versions, the card's name and power limit,
     nvcc, and a GPU, or it stops;
  B  build: both CUDA kernels from `emosaic_tpu_torch/csrc/`;
  C  each kernel against its plain torch version on the card, exactly:
     K1 (L1 argmin) and K2 (composite) at test and main-path shapes, the
     tint over all 256 alphas x 65536 pairs, the card's LUT against the
     CPU's, and a no-fallback run with the plain versions made to raise;
  D  the main path at the BASELINE size through `render_nto1`, from
     in-memory arrays: 100k synthetic tiles, mode 1 on a 4096^2 source
     (LUT), then mode 4 on a 2048^2 source (K1) streamed with a 0.3 tint
     into a PNG;
  E  the CLI, `python -m emosaic_tpu_torch.cli ... --device cuda`, on a
     generated 4000x3000 photo and 4096 tile files (needs Pillow);
  F  the launch counts of the main path's run (D), which must be > 0.

Any failed check raises, so the exit code is non-zero and no result line
is printed. The last lines are one JSON object per kernel, the card's
name and power limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"  # listed in .gitignore; removed at the end
SEED = 0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Err:
    """Largest |kernel - plain| seen over a kernel's comparisons."""

    def __init__(self):
        self.max = 0

    def add(self, torch, got, want, what: str) -> None:
        torch.cuda.synchronize()
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        self.max = max(self.max, err)
        check(err == 0, f"{what}: kernel differs from plain, max |err| = {err}")


# ---------------------------------------------------------------------------
# A, B
# ---------------------------------------------------------------------------


def phase_a(torch) -> str:
    log("== A. environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")
    from emosaic_tpu_torch.ops._kernels import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    log(nvcc.stdout.strip().splitlines()[-1])
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    log(f"torch.cuda.is_available(): True, {torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}")
    return card


def phase_b() -> None:
    from emosaic_tpu_torch.ops._kernels import KERNELS

    log("== B. build")
    for k in KERNELS:
        secs = k.build(force=True)
        log(f"built {k.source.relative_to(ROOT)} -> {k.library.relative_to(ROOT)} "
            f"in {secs:.2f} s")


# ---------------------------------------------------------------------------
# C
# ---------------------------------------------------------------------------


def _u8(torch, gen, shape, dev):
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)


def phase_c_k1(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.ops import distance

    err = Err()
    shapes = [(1, 3, 3), (5, 700, 12), (300, 513, 12), (70, 100, 200),
              (1536, 240, 3), (257, 1000, 192), (100, 600, 3072), (33, 50, 75)]
    for b, l, d in shapes:
        blocks, lib = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
        got = distance.l1_argmin(blocks, lib)
        want = distance.l1_argmin_ref(blocks, lib)
        err.add(torch, torch.stack(got), torch.stack(want), f"K1 B={b} L={l} D={d}")
    log(f"K1 test shapes {shapes}: exact")
    # tie storms: every library row repeated, so the lowest row must win;
    # the second one is small-B / large-L, which splits L across blocks
    for nbase, reps, d, b in [(40, 3, 12, 17), (5000, 4, 12, 17), (300, 2, 48, 4000)]:
        base = _u8(torch, gen, (nbase, d), dev)
        lib = base.repeat(reps, 1)
        pick = torch.randint(0, nbase, (b,), device=dev, generator=gen)
        dist, row = distance.l1_argmin(base[pick], lib)
        torch.cuda.synchronize()
        check(bool((dist == 0).all()) and bool((row == pick.to(torch.int32)).all()),
              f"K1 tie storm {nbase}x{reps}: not the lowest row")
        want = distance.l1_argmin_ref(base[pick], lib)
        err.add(torch, torch.stack((dist, row)), torch.stack(want), "K1 tie storm")
    one = _u8(torch, gen, (1, 48), dev).repeat(100000, 1)
    dist, row = distance.l1_argmin(_u8(torch, gen, (64, 48), dev), one)
    torch.cuda.synchronize()
    check(bool((row == 0).all()), "K1: all-equal library must give row 0")
    log("K1 tie storms: lowest row wins, exact")
    # the main-path shape: a 2048^2 source at mode 4 against 100k tiles
    b, l, d = 262144, 200000, 48
    blocks, lib = _u8(torch, gen, (b, d), dev), _u8(torch, gen, (l, d), dev)
    t0 = time.perf_counter()
    dist, row = distance.l1_argmin(blocks, lib)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    sample = torch.arange(0, b, b // 4096, device=dev)
    want = distance.l1_argmin_ref(blocks[sample], lib)
    err.add(torch, torch.stack((dist[sample], row[sample])), torch.stack(want),
            "K1 main-path shape (4096-block sample)")
    ms_full = cuda_ms(torch, lambda: distance.l1_argmin(blocks, lib), reps=3)
    sub = blocks[sample].contiguous()
    ms = cuda_ms(torch, lambda: distance.l1_argmin(sub, lib), reps=5)
    plain_ms = cuda_ms(torch, lambda: distance.l1_argmin_ref(sub, lib), reps=2)
    ops = b * l * d
    log(f"K1 B={b} L={l} D={d}: first call {first_s:.3f} s; {ms_full:.3f} ms "
        f"per call = {ops / ms_full / 1e9:.2f} T byte-absdiffs/s [{card}]")
    log(f"K1 B=4096 L={l} D={d}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms,
            "shape": f"B=4096 L={l} D={d}", "ms_main_path_shape": ms_full,
            "main_path_shape": f"B={b} L={l} D={d}"}


def phase_c_k2(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.ops import composite

    err = Err()

    def items_for(t, nby, nbx):
        it = torch.randint(-t, t + 1, (nby, nbx), dtype=torch.int32, device=dev,
                           generator=gen)
        it.view(-1)[:8] = torch.tensor(
            [0, t, -t, t + 7, -(t + 7), 1, 2**31 - 1, -(2**31)],
            dtype=torch.int32, device=dev)
        return it

    for t, ts, nby, nbx in [(5, 8, 3, 128), (1000, 12, 5, 300), (1000, 20, 5, 300),
                            (1000, 16, 4, 1000), (37, 32, 3, 77)]:
        aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
        items = items_for(t, nby, nbx)
        err.add(torch, composite.compose_rows(items, aug),
                composite.compose_rows_ref(items, aug), f"K2 T={t} ts={ts} nbx={nbx}")
    log("K2 ts 8/12/20/16/32, nbx 128/300/1000/77, items 0, +-T, out of range: exact")
    # the BASELINE band: 32 block-rows x 4096 tiles, ts = 32, T = 100k
    t, ts = 100000, 32
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    items = items_for(t, 32, 4096)
    err.add(torch, composite.compose_rows(items, aug),
            composite.compose_rows_ref(items, aug), "K2 BASELINE band")
    ms = cuda_ms(torch, lambda: composite.compose_rows(items, aug))
    plain_ms = cuda_ms(torch, lambda: composite.compose_rows_ref(items, aug))
    # past the TPU path's 131072 tiles per call, in one call
    many = items_for(t, 40, 4096)
    err.add(torch, composite.compose_rows(many, aug),
            composite.compose_rows_ref(many, aug), "K2 163840 tiles in one call")
    band = 32 * ts * 4096 * ts * 3
    log("K2 163840 tiles (> 131072) in one call: exact")
    log(f"K2 BASELINE band {band / 1e6:.1f} MB: kernel {ms:.3f} ms "
        f"({2 * band / ms / 1e6:.0f} GB/s moved), plain {plain_ms:.3f} ms [{card}]")
    del aug
    torch.cuda.empty_cache()
    # a 9.8 GB stack (T = 100k, ts = 128), items aimed past 4 GiB
    t, ts = 100000, 128
    aug, _ = composite.augment_stack2d(_u8(torch, gen, (t, ts, ts, 3), dev), device=dev)
    row_bytes = ts * ts * 3
    first_far = (1 << 32) // row_bytes + 1
    far = torch.randint(first_far + 1, t + 1, (2, 512), dtype=torch.int32, device=dev,
                        generator=gen)
    far[1] = -far[1]  # mirrored rows: all past T * row_bytes
    got, want = composite.compose_rows(far, aug), composite.compose_rows_ref(far, aug)
    err.add(torch, got, want, "K2 9.8 GB stack")
    log(f"K2 stack {aug.numel() / 1e9:.2f} GB, items at rows >= {first_far} "
        f"(byte offset > 4 GiB): exact")
    del aug, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": err.max, "ms": ms, "plain_ms": plain_ms,
            "shape": "items [32, 4096], T=100000, ts=32"}


def phase_c_tint_lut(torch, gen, dev, card) -> None:
    from emosaic_tpu_torch.ops import composite, distance, lut

    m = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None], (256, 256, 3))
    s = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None], (256, 256, 3))
    bad = 0
    for alpha in range(256):
        got = composite.tint_blend(m, s, (alpha + 0.5) / 255.0, device=dev)
        bad += int((got != composite.ref_tint_blend_u8(m, s, alpha)).sum())
    check(bad == 0, f"tint on the card: {bad} mismatches")
    log("tint: 256 alphas x 65536 pairs on the card, 0 mismatches")
    base = np.random.default_rng(SEED).integers(0, 256, (30000, 3), dtype=np.uint8)
    lib = np.concatenate([base, base[::3]])  # duplicate colours: lowest row
    t0 = time.perf_counter()
    on_card = lut.build_l1_lut(lib, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    on_cpu = lut.build_l1_lut(lib, device="cpu")
    t2 = time.perf_counter()
    check(torch.equal(on_card.cpu(), on_cpu), "LUT: card and CPU tables differ")
    q = _u8(torch, gen, (4096, 3), dev)
    d, r = lut.lut_match(q, on_card)
    wd, wr = distance.l1_argmin_ref(q, torch.as_tensor(lib, device=dev))
    check(torch.equal(d, wd) and torch.equal(r, wr), "LUT match != plain argmin")
    log(f"LUT: card table == CPU table, all 16.7M entries; build card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s [{card}]")


def _no_fallback():
    """Context: make both plain versions raise, so a run that completes
    went through the kernels."""
    import contextlib

    from emosaic_tpu_torch.ops import composite, distance

    @contextlib.contextmanager
    def ctx():
        saved = (distance.l1_argmin_ref, composite.compose_rows_ref)

        def refuse(*a, **k):
            raise AssertionError("a CUDA tensor reached a plain version")

        distance.l1_argmin_ref = composite.compose_rows_ref = refuse
        try:
            yield
        finally:
            distance.l1_argmin_ref, composite.compose_rows_ref = saved

    return ctx()


def phase_c_no_fallback(torch, gen, dev) -> None:
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.ops.analysis import analyse_batch
    from emosaic_tpu_torch.render.matched import match_blocks, render_nto1
    from emosaic_tpu_torch.tiles.tileset import TileSet

    stack = _u8(torch, gen, (300, 16, 16, 3), dev)
    pal = analyse_batch(stack, 4, device=dev).cpu().numpy()
    ts = TileSet.from_arrays(pal, [f"t{i}.jpg" for i in range(300)])
    src = np.random.default_rng(SEED).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    with _no_fallback():
        res = render_nto1(src, ts, 16, device=dev, stack=stack)
    cpu = render_nto1(src, ts, 16, device="cpu", stack=stack.cpu().numpy())
    check(np.array_equal(res.image, cpu.image), "no-fallback run != CPU run")
    # the dedup route: few unique blocks among > 8192
    blocks = _u8(torch, gen, (100, 48), dev)[
        torch.randint(0, 100, (20000,), device=dev, generator=gen)]
    lib = _u8(torch, gen, (600, 48), dev)
    with _no_fallback():
        d, r = match_blocks(blocks, lib)
    wd, wr = distance.l1_argmin_ref(blocks, lib)
    check(np.array_equal(d, wd.cpu().numpy()) and np.array_equal(r, wr.cpu().numpy()),
          "dedup route != plain argmin")
    log("no fallback: render_nto1 (mode 4, composite) and the dedup route ran "
        "with both plain versions raising; equal to the CPU run")


# ---------------------------------------------------------------------------
# D
# ---------------------------------------------------------------------------


def synthetic_photo(torch, h, w, gen, dev) -> np.ndarray:
    """A smooth colour field with fine noise: a stand-in photo whose blocks
    are mostly distinct."""
    y = torch.linspace(0, 1, h, device=dev)[:, None]
    x = torch.linspace(0, 1, w, device=dev)[None, :]
    r = 127.5 + 127.5 * torch.sin(6.2832 * (1.3 * x + 0.7 * y))
    g = 255.0 * y * torch.ones_like(x)
    b = 255.0 * x * (1 - y) + 60.0 * torch.cos(9.0 * x * y)
    img = torch.stack([r, g, b], -1)
    img = img + 6.0 * torch.randn(img.shape, device=dev, generator=gen)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def synthetic_tiles(torch, t, ts, gen, dev):
    """t tiles, each a random base colour plus noise (the verify recipe)."""
    base = torch.randint(0, 256, (t, 1, 1, 3), device=dev, generator=gen).float()
    noise = 30.0 * torch.randn((t, ts, ts, 3), device=dev, generator=gen)
    return (base + noise).clamp(0, 255).to(torch.uint8)


def png_rows(path: Path, rows) -> tuple[int, int, dict]:
    """Parse a PNG written by StreamingPNGWriter (CRCs checked) and return
    (width, height, {row: [W*3] u8}) for the asked rows."""
    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, idat, w, h = 8, [], 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos : pos + 4])[0]
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0]
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"PNG {tag} CRC")
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    check(raw.size == h * (1 + w * 3), "PNG data size")
    raw = raw.reshape(h, 1 + w * 3)
    out = {}
    for y in rows:
        ftype, f = int(raw[y, 0]), raw[y, 1:]
        check(ftype in (0, 1), f"PNG filter {ftype}")
        if ftype == 1:  # Sub: running sum per channel, mod 256
            f = (np.cumsum(f.reshape(w, 3).astype(np.int64), axis=0) % 256)
            f = f.astype(np.uint8).reshape(-1)
        out[y] = f
    return w, h, out


def expected_row(items, stack_host, y, ts):
    """Host composite of output row y from the items grid and the stack."""
    by, r = divmod(y, ts)
    parts = []
    for it in items[by]:
        if it == 0:
            parts.append(np.zeros((ts, 3), np.uint8))
        else:
            tile = stack_host[abs(int(it)) - 1]
            parts.append(tile[r, ::-1] if it < 0 else tile[r])
    return np.concatenate(parts).reshape(-1)


def phase_d(torch, gen, dev, card) -> dict:
    from emosaic_tpu_torch.io.codecs import StreamingPNGWriter
    from emosaic_tpu_torch.ops import composite, distance
    from emosaic_tpu_torch.ops._kernels import KERNELS
    from emosaic_tpu_torch.ops.analysis import analyse_batch, source_blocks
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.tiles.tileset import TileSet

    times = {}
    t_tiles = 100000
    paths = [f"synthetic/{i:06d}.jpg" for i in range(t_tiles)]
    t0 = time.perf_counter()
    stack32 = synthetic_tiles(torch, t_tiles, 32, gen, dev)
    stack16 = torch.nn.functional.avg_pool2d(
        stack32.permute(0, 3, 1, 2).float(), 2).permute(0, 2, 3, 1).to(torch.uint8).contiguous()
    src1 = synthetic_photo(torch, 4096, 4096, gen, dev)
    src4 = synthetic_photo(torch, 2048, 2048, gen, dev)
    torch.cuda.synchronize()
    times["set-up: 100k synthetic tiles + sources"] = time.perf_counter() - t0
    out_png = WORK / "mode4_tinted.png"
    WORK.mkdir(parents=True, exist_ok=True)

    for k in KERNELS:
        k.launches = 0
    t_main = time.perf_counter()
    with _no_fallback():
        t0 = time.perf_counter()
        pal1 = analyse_batch(stack32, 1, device=dev).cpu().numpy()
        pal4 = analyse_batch(stack16, 4, device=dev).cpu().numpy()
        times["analyse_batch 100k tiles (dims 1 and 4)"] = time.perf_counter() - t0
        ts1 = TileSet.from_arrays(pal1, paths)
        ts4 = TileSet.from_arrays(pal4, paths)
        t0 = time.perf_counter()
        res1 = render_nto1(src1, ts1, 32, device=dev, compose=False)
        times["mode 1 4096^2 match (LUT, 16.7M blocks)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bands = list(itertools.islice(
            composite.iter_bands(res1.items, stack32, 8, device=dev), 2))
        times["mode 1 two bands via iter_bands (2 x 100.7 MB)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res4 = render_nto1(src4, ts4, 16, device=dev, compose=False)
        times["mode 4 2048^2 match (K1, 262144 blocks x 200k rows)"] = (
            time.perf_counter() - t0)
        t0 = time.perf_counter()
        with StreamingPNGWriter(out_png, 8192, 8192) as w:
            for band in composite.stream_tinted_bands(
                res4.items, ts4, stack16, 16, original_rgb=src4, tint_opacity=0.3,
                device=dev,
            ):
                w.write_band(band)
        times["mode 4 8192^2 composite + tint 0.3 + PNG stream"] = (
            time.perf_counter() - t0)
    times["main path total"] = time.perf_counter() - t_main
    launches = {k.name: k.launches for k in KERNELS}
    for name, secs in times.items():
        log(f"D {name}: {secs:.3f} s [{card}]")
    log(f"D launches in the main path's run: {launches}")

    # outputs: the mode-1 items equal the same call on the CPU
    t0 = time.perf_counter()
    cpu1 = render_nto1(src1, ts1, 32, device="cpu", compose=False)
    check(np.array_equal(res1.items, cpu1.items), "mode 1 items: card != CPU")
    log(f"mode 1 items grid {res1.items.shape} == CPU run "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")
    stack32_h = stack32.cpu().numpy()
    for i, band in enumerate(bands):
        check(band.shape == (256, 4096 * 32, 3), f"band shape {band.shape}")
        flat = band.reshape(256, -1)
        for y in (0, 37, 255):
            want = expected_row(res1.items, stack32_h, i * 256 + y, 32)
            check(np.array_equal(flat[y], want), f"mode 1 band {i} row {y}")
    log("mode 1 bands: rows equal the host composite of the items grid")
    # mode 4: K1's choice on a block sample equals the plain argmin
    blocks4 = source_blocks(src4, 4, device=dev)
    lib4 = distance.build_library(torch.as_tensor(pal4, device=dev))
    sample = np.arange(0, blocks4.shape[0], blocks4.shape[0] // 4096)
    wd, wr = distance.l1_argmin_ref(blocks4[torch.as_tensor(sample, device=dev)], lib4)
    got = distance.rows_to_items(wr.cpu(), t_tiles).numpy()
    check(np.array_equal(res4.items.reshape(-1)[sample], got), "mode 4 items != plain")
    check(np.array_equal(res4.stats._get_arrays()[3][sample], wd.cpu().numpy()),
          "mode 4 distances != plain")
    # mode 4 PNG: sampled rows equal the host composite + reference tint
    stack16_h = stack16.cpu().numpy()
    rows = [0, 1, 15, 16, 4095, 4096, 8191]
    w, h, got_rows = png_rows(out_png, rows)
    check((w, h) == (8192, 8192), f"PNG size {w}x{h}")
    alpha = int(255.0 * 0.3)
    for y in rows:
        mosaic = expected_row(res4.items, stack16_h, y, 16)
        yi, xi3 = composite._tint_sample_indices(1, 8192, 2048, 2048, 8192, y)
        fg = src4.reshape(2048, -1)[yi][:, xi3][0]
        want = composite.ref_tint_blend_u8(mosaic, fg, alpha)
        check(np.array_equal(got_rows[y], want), f"mode 4 PNG row {y}")
    log(f"mode 4: items equal the plain argmin on {sample.size} blocks; PNG "
        f"{out_png.stat().st_size / 1e6:.1f} MB, rows {rows} equal the reference "
        "composite + tint")
    out_png.unlink()
    return launches


# ---------------------------------------------------------------------------
# E
# ---------------------------------------------------------------------------


def phase_e(card) -> None:
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # the outputs are 192 MP
    rng = np.random.default_rng(SEED)
    tiles = WORK / "tiles"
    tiles.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(4096):
        base = rng.integers(0, 256, size=3)
        img = np.clip(base + rng.normal(0, 30, (40, 40, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(tiles / f"t{i:04d}.jpg", quality=90)
    h, w = 3000, 4000
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    photo = np.stack([
        127.5 + 127.5 * np.sin(6.2832 * (1.3 * x / w + 0.7 * y / h)),
        255.0 * y / h,
        255.0 * (x / w) * (1 - y / h) + 60.0 * np.cos(9.0 * x * y / (w * h)),
    ], -1)
    photo = np.clip(photo + rng.normal(0, 6, photo.shape), 0, 255).astype(np.uint8)
    Image.fromarray(photo).save(WORK / "photo.jpg", quality=92)
    log(f"E scene: 4096 tiles + a {w}x{h} photo in {time.perf_counter() - t0:.1f} s")
    env = dict(os.environ, XDG_CACHE_HOME=str(WORK / "xdg"),
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    from emosaic_tpu_torch.cli import preprocess_source

    for mode, size, down in [(1, 16, 4), (4, 32, 2)]:
        out = WORK / f"m{mode}.png"
        cmd = [sys.executable, "-m", "emosaic_tpu_torch.cli", "-s", str(size),
               "-o", str(out), str(WORK / "photo.jpg"), "mosaic", str(tiles),
               "-m", str(mode), "--downsample", str(down), "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=WORK, env=env)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise AssertionError(f"CLI -m {mode} exited {proc.returncode}")
        src = preprocess_source(Image.open(WORK / "photo.jpg"), down, mode)
        with Image.open(out) as im:
            a = np.asarray(im.convert("RGB"))
        nby, nbx = src.shape[0] // mode, src.shape[1] // mode
        check(a.shape == (nby * size, nbx * size, 3), f"CLI output shape {a.shape}")
        bm = a.reshape(nby, size, nbx, size, 3).mean((1, 3))
        sm = src.reshape(nby, mode, nbx, mode, 3).mean((1, 3))
        corr = float(np.corrcoef(bm.ravel(), sm.ravel())[0, 1])
        check(corr > 0.9, f"CLI -m {mode}: block-mean correlation {corr:.3f}")
        check(out.with_suffix(".stats.png").exists(), "stats PNG missing")
        timings = [ln.strip() for ln in proc.stderr.splitlines()
                   if ln.startswith("   ") and ln.strip().endswith("s")][:5]
        log(f"E CLI -m {mode} -s {size} --downsample {down}: {secs:.1f} s, "
            f"{a.shape[1]}x{a.shape[0]}, block-mean corr {corr:.4f}; "
            f"{'; '.join(timings)} [{card}]")
        out.unlink()


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs a GPU",
              file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops._kernels import KERNELS

    shutil.rmtree(WORK, ignore_errors=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t_all = time.perf_counter()
    try:
        card = phase_a(torch)
        phase_b()
        log("== C. kernels against their plain versions on the card")
        k1 = phase_c_k1(torch, gen, dev, card)
        k2 = phase_c_k2(torch, gen, dev, card)
        phase_c_tint_lut(torch, gen, dev, card)
        phase_c_no_fallback(torch, gen, dev)
        log("== D. main path at the BASELINE size")
        launches = phase_d(torch, gen, dev, card)
        torch.cuda.empty_cache()
        log("== E. the CLI")
        phase_e(card)
        log("== F. counters")
        for k in KERNELS:
            log(f"{k.name}: {launches[k.name]} launches in D")
            check(launches[k.name] > 0, f"{k.name} was not launched by the main path")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    rows = []
    for k, res, replaces in [
        (KERNELS[0], k1, "emosaic_tpu/ops/distance.py:190"),
        (KERNELS[1], k2, "emosaic_tpu/ops/composite.py:119"),
    ]:
        rows.append({
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)), "replaces": replaces,
            "launches": launches[k.name], **res,
        })
    rows[1]["also_replaces"] = "emosaic_tpu/ops/composite.py:82"
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
