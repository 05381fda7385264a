#!/usr/bin/env python3
"""The segment top-cap lab probe on a GPU: kernel K4
(`csrc/seg_topcap.cu`) inside the adaptive scorer's coarse pass, the
counterpart of `tools/tpu_r14_seg8.py`.

    python -m emosaic_tpu_torch.probes.seg8

At the tool's shape: B = 16384 blocks, D = 3072, groups of G = 32 cells
per channel, CAP = 8, L = 200,000 library rows, from its clustered recipe
(512 centres plus N(0, 12) noise, seed 11), made on the card with torch's
generator, so the values are not numpy's. Phases:

  I  `seg_topk` on a CPU tensor (K4's plain version) and on the card (K4)
     against the tool's contract, a stable per-segment argsort, on the
     tool's own case: a full-tie segment, a `_TL_BIG` lookalike and an
     nseg off the 128 grid; caps 8 and 16;
  B  the coarse pass `_ad_coarse` on the card with the plain selection
     `_seg_topcap_ref` (the port's selection before K4);
  P  the same pass with K4: bit-equal to B, with both passes' times (host
     clock around a synchronized call, the second of two runs), and the
     selection alone on one chunk of the pass (CUDA events): K4, its plain
     version, and `torch.topk` on the packed keys.

The tool's phase F (its coarse pass with an f32-keyed `lax.top_k`) is left
out: the port selects on packed int64 keys, which have no f32 form.
Prints the card's name and power limit first; fails without a GPU.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.ops._kernels import SEG_TOPCAP

B, D, G, CAP, L = 16384, 3072, 32, 8, 200_000
CENTRES, NOISE, SEED = 512, 12.0, 11


def log(*a):
    print(*a, flush=True)


def clustered(n: int, centres: torch.Tensor, gen: torch.Generator, rows: int = 1 << 15):
    """n rows u8: a random centre each, plus N(0, NOISE), clipped; made in
    row chunks on the centres' device."""
    out = torch.empty((n, centres.shape[1]), dtype=torch.uint8, device=centres.device)
    for r0 in range(0, n, rows):
        m = min(rows, n - r0)
        pick = torch.randint(0, centres.shape[0], (m,), device=centres.device, generator=gen)
        noise = torch.randn((m, centres.shape[1]), device=centres.device, generator=gen)
        out[r0 : r0 + m] = (centres[pick] + NOISE * noise).clamp(0, 255).to(torch.uint8)
    return out


def contract(seg: np.ndarray, cap: int):
    """The tool's contract, independently: ascending values, the lowest
    lane first among equal ones (a stable argsort per segment)."""
    idx = np.argsort(seg, axis=2, kind="stable")[:, :, :cap]
    return np.take_along_axis(seg, idx, axis=2), idx.astype(np.int32)


def phase_i(dev) -> None:
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 50, size=(32, 130, 128)).astype(np.int32)
    seg[0, 0, :] = 7
    seg[1, 3, 10:] = distance._TL_BIG
    for cap in (8, 16):
        want = contract(seg, cap)
        for where in (torch.device("cpu"), dev):
            got = distance.seg_topk(torch.from_numpy(seg).to(where), cap)
            for g, w in zip(got, want):
                if not np.array_equal(g.cpu().numpy(), w):
                    raise AssertionError(f"seg_topk on {where}, cap {cap}: not the contract")
    log("I seg_topk [32, 130, 128], cap 8 and 16, on the CPU (plain) and the card (K4): "
        "equal to the stable per-segment argsort")


@contextlib.contextmanager
def plain_selection():
    """Run the coarse pass with the plain selection on the card."""
    saved = distance.seg_topcap
    distance.seg_topcap = distance._seg_topcap_ref
    try:
        yield
    finally:
        distance.seg_topcap = saved


def timed(fn, dev):
    """(result, seconds) of the second of two synchronized runs."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def events_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(reps):
        fn()
    en.record()
    torch.cuda.synchronize()
    return st.elapsed_time(en) / reps


def probe(dev, card: str = "", b: int = B, l: int = L, d: int = D, g: int = G,
          cap: int = CAP) -> dict:
    """Phases I, B and P on `dev`; returns their times and K4's launches."""
    phase_i(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    centres = torch.randint(0, 256, (CENTRES, d), device=dev, generator=gen).float()
    lib = clustered(l, centres, gen)
    blocks = clustered(b, centres, gen)
    del centres
    lp = -(-l // distance._TL_SEG) * distance._TL_SEG
    lib_pad = distance._pad_lib(lib, lp, dev)
    del lib
    coarse_lib = distance._ad_coarse_lib(lib_pad, d, g, True, l)
    torch.cuda.synchronize(dev)
    log(f"B/P inputs: {b} blocks and {l} library rows of D={d}, clustered "
        f"({CENTRES} centres, N(0, {NOISE:g}), seed {SEED}), on the card")

    def coarse():
        return distance._ad_coarse(blocks, coarse_lib, d, g, True, cap)

    with plain_selection():
        (keys_b, smin_b), plain_s = timed(coarse, dev)
    SEG_TOPCAP.launches = 0
    (keys_p, smin_p), k4_s = timed(coarse, dev)
    launches = SEG_TOPCAP.launches
    if not (torch.equal(keys_b, keys_p) and torch.equal(smin_b, smin_p)):
        raise AssertionError("P: the K4 coarse pass differs from the plain one")
    nseg = lp // distance._TL_SEG
    log(f"B coarse pass, plain selection: {plain_s:.3f} s [{card}]")
    log(f"P coarse pass, K4: {k4_s:.3f} s, keys [{b}, {nseg}*{cap}] and s_min bit-equal "
        f"to B; {launches // 2} K4 launches a pass [{card}]")
    del keys_b, smin_b, keys_p, smin_p

    # the selection alone on one chunk of the pass
    rows = min(b, max(1, distance._AD_COARSE_KEY_BYTES // (8 * lp)))
    proj, cols, real_l = coarse_lib
    dist = distance.l1_block(distance._ad_project(blocks[:rows], d, g, True), proj)
    keys = distance._keys(dist.masked_fill(cols >= real_l, distance._TL_BIG), cols)
    k4_ms = events_ms(lambda: distance.seg_topcap(dist, cols, cap, real_l))
    plain_ms = events_ms(lambda: distance._seg_topcap_ref(dist, cols, cap, real_l))
    lib_ms = events_ms(lambda: torch.topk(keys.view(rows, nseg, distance._TL_SEG), cap,
                                          dim=2, largest=False))
    log(f"P selection of one chunk [{rows}, {lp}] int32, cap {cap}: K4 {k4_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.topk on the packed keys {lib_ms:.3f} ms [{card}]")
    del dist, keys, lib_pad, coarse_lib, blocks
    torch.cuda.empty_cache()
    return {"coarse_plain_s": plain_s, "coarse_k4_s": k4_s, "k4_ms": k4_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "rows": rows, "lp": lp,
            "nseg": nseg, "cap": cap}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("seg8 probe: needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    probe(torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
