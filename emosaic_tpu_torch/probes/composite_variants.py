#!/usr/bin/env python3
"""The composite variants probe on a GPU: the counterpart of
`tools/tpu_bench_composite_variants.py`.

    python -m emosaic_tpu_torch.probes.composite_variants

At the tool's shape: ts = 32, T = 100,000 tiles (random bytes), items
uniform in [1, 100000], a band of 128 x 4096 blocks (1.61 GB), made on the
card with torch's generator. It times (CUDA events, the mean of `REPS`
calls after a warm-up) the tool's variants and K2:

  v1   `composite.compose_rows_ref`: the gather (`index_select`) and a
       permuting reshape;
  v4   the gather, then the permuting copy on an int32 view of the rows;
  v3d  the gather, then K8 (`composite_lab.band_transpose`): the tool's
       XLA gather and Pallas relayout;
  K2   `composite.compose_rows`, the fused kernel;

holds each band equal to v1's on the whole band, and times the relayout
alone three ways on the gathered tiles: K8, the library copy `copy_` of a
transposed view, and the same copy on an int32 view (v4's). Then the
tool's match-phase breakdown through the port's own modules: the LUT
build (`ops/lut.py`, host clock around a synchronized call, cache off)
over the mode-1 library of the tiles (200k rows), the LUT match of a
4096^2 source, and the analysis (`ops/analysis.py`) of the 100k tiles.
Prints the card's name and power limit on every timed line; fails
without a GPU.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from emosaic_tpu_torch.ops import analysis, composite, composite_lab, distance, lut
from emosaic_tpu_torch.probes.seg8 import card_line, events_ms, log

TS, T, NBY, NBX = 32, 100_000, 128, 4096
REPS = 5
SEED = 1


def gather(items: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
    """The selected tiles [nby*nbx, ts, ts*3], in block order."""
    return aug.index_select(0, composite.rows_of(items, aug.shape[0] // 2))


def relayout_copy(sel: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """The library call for K8: one `copy_` of a transposed view."""
    ts, w = sel.shape[1], sel.shape[2]
    out = torch.empty((nby * ts, nbx * w), dtype=torch.uint8, device=sel.device)
    out.view(nby, ts, nbx, w).copy_(sel.view(nby, nbx, ts, w).transpose(1, 2))
    return out


def relayout_copy_i32(sel: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """The tool's v4 relayout: the same copy on an int32 view (w % 4 == 0)."""
    ts, w = sel.shape[1], sel.shape[2]
    words = sel.view(torch.int32).view(nby, nbx, ts, w // 4)
    out = torch.empty((nby, ts, nbx, w // 4), dtype=torch.int32, device=sel.device)
    out.copy_(words.transpose(1, 2))
    return out.view(torch.uint8).view(nby * ts, nbx * w)


def v1(items, aug):
    return composite.compose_rows_ref(items, aug)


def v4(items, aug):
    return relayout_copy_i32(gather(items, aug), *items.shape)


def v3d(items, aug):
    return composite_lab.band_transpose(gather(items, aug), *items.shape)


def k2(items, aug):
    return composite.compose_rows(items, aug)


#: the band functions, (items, aug) -> band
VARIANTS = {"v1": v1, "v4": v4, "v3d": v3d, "K2": k2}


def host_ms(fn, dev, reps: int = 3) -> float:
    """Mean host-clock ms of fn() ending in a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def probe(dev, card: str = "", ts: int = TS, t: int = T, nby: int = NBY,
          nbx: int = NBX, reps: int = REPS) -> dict:
    """The variants, the relayouts and the match phases on `dev`; returns
    their ms. Raises when a band differs from v1's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tiles = torch.randint(0, 256, (t, ts, ts, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    aug, _ = composite.augment_stack2d(tiles, device=dev)
    items = torch.randint(1, t + 1, (nby, nbx), dtype=torch.int32, device=dev,
                          generator=gen)
    band_bytes = nby * ts * nbx * ts * 3
    log(f"inputs: {t} tiles of ts = {ts}, items [{nby}, {nbx}] in [1, {t}], a "
        f"{band_bytes / 1e9:.2f} GB band, on the card")
    out = {}
    want = v1(items, aug)
    for name, fn in VARIANTS.items():
        out[name] = events_ms(lambda: fn(items, aug), reps)
        if name != "v1" and not torch.equal(fn(items, aug), want):
            raise AssertionError(f"{name}: band differs from v1's")
        log(f"{name}: {out[name]:.3f} ms/band, {band_bytes / out[name] / 1e6:.1f} GB/s "
            f"of band [{card}]")
    log("v4, v3d and K2 equal v1 on the whole band")
    sel = gather(items, aug)
    out["gather"] = events_ms(lambda: gather(items, aug), reps)
    for name, fn in (("K8", composite_lab.band_transpose), ("copy_", relayout_copy),
                     ("copy_ int32", relayout_copy_i32)):
        out[f"relayout {name}"] = events_ms(lambda: fn(sel, nby, nbx), reps)
        log(f"relayout alone, {name}: {out[f'relayout {name}']:.3f} ms "
            f"({2 * band_bytes / out[f'relayout {name}'] / 1e6:.1f} GB/s moved) [{card}]")
    log(f"the gather alone (index_select): {out['gather']:.3f} ms [{card}]")
    del sel, want
    torch.cuda.empty_cache()

    # the match-phase breakdown
    pal = analysis.analyse_batch(tiles, 1, device=dev)
    out["analysis"] = events_ms(lambda: analysis.analyse_batch(tiles, 1, device=dev), reps)
    lib = distance.build_library(pal)
    saved = os.environ.get("EMOSAIC_LUT_CACHE")
    os.environ["EMOSAIC_LUT_CACHE"] = "0"
    try:
        table = lut.build_l1_lut(lib, device=dev)
        out["lut build"] = host_ms(lambda: lut.build_l1_lut(lib, device=dev), dev)
    finally:
        if saved is None:
            del os.environ["EMOSAIC_LUT_CACHE"]
        else:
            os.environ["EMOSAIC_LUT_CACHE"] = saved
    src = torch.randint(0, 256, (4096 * 4096, 3), dtype=torch.uint8, device=dev,
                        generator=gen)
    out["lut match"] = events_ms(lambda: lut.lut_match(src, table), reps)
    log(f"lutbuild ({lib.shape[0]} rows, host clock): {out['lut build']:.1f} ms; "
        f"lutgather (4096^2 source): {out['lut match']:.3f} ms; analysis ({t} tiles, "
        f"dim 1): {out['analysis']:.3f} ms [{card}]")
    del aug, items, tiles, table, src
    torch.cuda.empty_cache()
    return {"ms": out, "band_bytes": band_bytes}


def main() -> int:
    if not torch.cuda.is_available():
        print("composite_variants probe: needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    probe(torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
