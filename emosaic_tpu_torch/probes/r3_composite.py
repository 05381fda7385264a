#!/usr/bin/env python3
"""The composite lab probe on a GPU: the counterpart of the composite
halves of `tools/tpu_r3_experiments.py`, `tpu_r3_experiments2.py` and
`tpu_r3_experiments3.py`.

    python -m emosaic_tpu_torch.probes.r3_composite

At the tools' shape: T = 100,000 tiles of ts = 32 (random bytes), one band
of 32 x 4096 blocks (402.65 MB), items uniform in [-100000, 100000], made
on the card with torch's generator. One line per experiment, with its time
(CUDA events, the mean of `REPS` calls after a warm-up), the band's bytes
over that time, and the card's name and power limit:

  C0   K2 (`composite.compose_rows`), the shipped composite;
  C1   the tool's double-buffered `_compose_rows_dma_db`, which the JAX
       package no longer has: K7 at C;
  C4   K2 on the tool's sequential rows (items 1..512, eight times a row):
       does index locality matter?
  C5   K5 (`floor_write`), the write floor through bulk stores, and
       `fill_`, the floor through thread stores;
  C6   K6 at C (the tool's unrolled issue at ch = 128);
  C8   K7 at C (the tool's double buffer at ch = 128);
  C9   K6 at 2C (the tool's single buffer at ch = 256);
  C10  K7 at 2C (the tool's double buffer at ch = 256).

C = `composite_lab.RUN` = 16 tiles. A TPU chunk of ch = 128 tiles is 512 KB
of VMEM and does not fit a block's 227 KB of shared memory, so a run is
tiles per stage that fit; what a run's size changes on this card is the
tiles resident per SM (each line states them, from the card's 228 KB of
shared memory per SM), so C9 and C10 ask "more tiles in flight", not
"ch = 256". The EQ lines hold every band bit-equal to K2's on the whole
band, and the floor band equal to `fill_`'s. Fails without a GPU.
"""

from __future__ import annotations

import functools
import sys

import torch

from emosaic_tpu_torch.ops import composite, composite_lab
from emosaic_tpu_torch.probes.seg8 import card_line, events_ms, log

T, TS, NBY, NBX = 100_000, 32, 32, 4096
C = composite_lab.RUN
REPS = 10
SEED = 0
#: an H100 SM's shared memory, and what each resident block reserves of it
SMEM_PER_SM, SMEM_PER_BLOCK = 233472, 1024
#: threads per block of K6 and K7 (`kThreads` in csrc/compose_bulk.cu)
BULK_THREADS = 256


def band_fns(c: int = C) -> dict:
    """name -> (what it is, (items, aug) -> band) for the experiments that
    compose a band; the bulk ones are partials whose keywords give their
    stages and run."""
    bulk = composite_lab.compose_rows_bulk
    return {
        "C0": ("K2", composite.compose_rows),
        "C1": (f"K7 at C = {c} (the tool's _compose_rows_dma_db)",
               functools.partial(bulk, stages=2, run=c)),
        "C6": (f"K6 at C = {c} (ch = 128, unrolled issue)",
               functools.partial(bulk, stages=1, run=c)),
        "C8": (f"K7 at C = {c} (ch = 128, double-buffered)",
               functools.partial(bulk, stages=2, run=c)),
        "C9": (f"K6 at 2C = {2 * c} (ch = 256, single-buffered)",
               functools.partial(bulk, stages=1, run=2 * c)),
        "C10": (f"K7 at 2C = {2 * c} (ch = 256, double-buffered)",
                functools.partial(bulk, stages=2, run=2 * c)),
    }


def resident_tiles(stages: int, run: int, ts: int) -> int:
    """Tiles resident per SM when shared memory and the thread count are
    what limit the blocks of K6 or K7."""
    smem = 128 + stages * run * ts * ts * 3
    blocks = min(2048 // BULK_THREADS, SMEM_PER_SM // (smem + SMEM_PER_BLOCK))
    return blocks * stages * run


def sequential_items(nby: int, nbx: int, dev) -> torch.Tensor:
    """The tool's C4 items: 1 .. nbx/8, repeated eight times along a row."""
    return torch.arange(1, nbx // 8 + 1, dtype=torch.int32, device=dev).repeat(nby, 8)


def probe(dev, card: str = "", t: int = T, ts: int = TS, nby: int = NBY,
          nbx: int = NBX, reps: int = REPS) -> dict:
    """Every experiment on `dev`; returns their ms by name. Raises when a
    band differs from K2's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tiles = torch.randint(0, 256, (t, ts, ts, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    aug, _ = composite.augment_stack2d(tiles, device=dev)
    del tiles
    items = torch.randint(-t, t + 1, (nby, nbx), dtype=torch.int32, device=dev,
                          generator=gen)
    band_bytes = nby * ts * nbx * ts * 3
    log(f"inputs: {t} tiles of ts = {ts}, items [{nby}, {nbx}] in [-{t}, {t}], a "
        f"{band_bytes / 1e6:.2f} MB band, on the card; C = {C} tiles for the TPU's "
        f"ch = 128, 2C = {2 * C} for ch = 256")

    def line(name, what, ms, extra=""):
        log(f"{name} {what}: {ms:.4f} ms/band, {band_bytes / ms / 1e6:.1f} GB/s of "
            f"band{extra} [{card}]")

    out = {}
    fns = band_fns()
    want = composite.compose_rows(items, aug)
    for name, (what, fn) in fns.items():
        out[name] = events_ms(lambda: fn(items, aug), reps)
        kw = getattr(fn, "keywords", None)
        extra = ""
        if kw:
            extra = (f"; {resident_tiles(kw['stages'], kw['run'], ts)} tiles resident "
                     "per SM")
        line(name, what, out[name], extra)
    seq = sequential_items(nby, nbx, dev)
    out["C4"] = events_ms(lambda: composite.compose_rows(seq, aug), reps)
    line("C4", "K2 on sequential rows (locality)", out["C4"])
    seed = torch.full((8, 128), 200, dtype=torch.uint8, device=dev)
    seed[0, 0] = 7
    h, w = nby * ts, nbx * ts * 3
    out["C5"] = events_ms(lambda: composite_lab.floor_write(seed, h, w), reps)
    filled = torch.empty((h, w), dtype=torch.uint8, device=dev)
    out["C5_fill"] = events_ms(lambda: filled.fill_(seed[0, 0]), reps)
    line("C5", "K5 write floor (bulk stores)", out["C5"])
    line("C5", "fill_ write floor (thread stores)", out["C5_fill"])

    for name, (what, fn) in fns.items():
        if name != "C0" and not torch.equal(fn(items, aug), want):
            raise AssertionError(f"EQ {name} ({what}): band differs from K2's")
    seq_want = composite.compose_rows_ref(seq, aug)
    if not torch.equal(composite.compose_rows(seq, aug), seq_want):
        raise AssertionError("EQ C4: K2 on sequential rows differs from its plain version")
    if not torch.equal(composite_lab.floor_write(seed, h, w), filled):
        raise AssertionError("EQ C5: the K5 band differs from fill_'s")
    log(f"EQ C1 C6 C8 C9 C10 bit-equal to C0 (K2) on the whole {nby} x {nbx} band; "
        "C4 equal to its plain version; C5 equal to fill_")
    del aug, items, want, seq, seq_want, filled
    torch.cuda.empty_cache()
    return {"ms": out, "band_bytes": band_bytes, "run": C}


def main() -> int:
    if not torch.cuda.is_available():
        print("r3_composite probe: needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    probe(torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
