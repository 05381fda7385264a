#!/usr/bin/env python3
"""Device-memory accounting of the adaptive scorer at a 2M-row library
on a GPU, the counterpart of `tools/tpu_r19_flatdma.py`.

    python -m emosaic_tpu_torch.probes.flatdma

The TPU tool asked whether the shortlist rescore's [LP, sl, lw] reshape
copied the whole library (6.1 GB at L = 2M) on the way into the kernel,
and tried a flat [LP*sl, lw] layout (`_l1_rows_kernel2`). K3
(`csrc/l1_rows.cu`) already addresses the library flat, one base pointer
and 64-bit row offsets, so the question here is whether any step of the
port's scorer copies the library again. Shapes: LP = 2,000,000 rows of
D = 3072 (a 6.14 GB u8 library made on the card from a seed, in the JAX
bench's tile model: a random base colour per row plus +-10 texture per
cell; the blocks are library rows plus +-6 noise, data the adaptive
certificate covers), M = 8192 candidates, a 1024-row block slice. For
each step it prints the bytes of its inputs (args), of its device outputs
(out), of its peak above both (temp) and their sum, in GiB, from
`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`:

  A  K3 alone (`l1_rows`), random candidates;
  D  the coarse pass at g = 32 per channel and cap = 8 (`_ad_coarse_lib`
     and `_ad_coarse`);
  C  the rescore `_ad_rescore` at m = 8192, k = 512, on D's survivors;
  W  the whole `l1_topk_adaptive` for the 1024 blocks (at this size
     `_ad_params` gives m = 8192 and cap = 8, and the certificate's audit
     runs).

A, D and C fail on a temporary of the library's size. W holds one padded
copy of the library by design (`_pad_lib`); the probe reports whether it
doubles the resident library and fails on a second copy. Prints the
card's name and power limit first; fails without a GPU.
"""

from __future__ import annotations

import sys

import torch

from emosaic_tpu_torch.ops import distance
from emosaic_tpu_torch.probes.seg8 import card_line, log

LP, D, M, B_SLICE, K = 2_000_000, 3072, 8192, 1024, 512
G, CAP = 32, 8
SEED = 19
GIB = 1 << 30


def palette_rows(n: int, d: int, gen: torch.Generator, rows: int = 1 << 16):
    """n rows [n, d] u8: a random base colour each plus +-10 texture per
    cell (d = 3 * cells), made in row chunks on the generator's device."""
    dev = gen.device
    out = torch.empty((n, d), dtype=torch.uint8, device=dev)
    for r0 in range(0, n, rows):
        m = min(rows, n - r0)
        base = torch.randint(0, 256, (m, 1, 3), device=dev, generator=gen)
        tex = torch.randint(-10, 11, (m, d // 3, 3), device=dev, generator=gen)
        out[r0 : r0 + m] = (base + tex).clamp(0, 255).to(torch.uint8).view(m, d)
    return out


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor)
               and t.device.type == "cuda")


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat(y)]
    return [x]


def measure(tag: str, fn, args: tuple, lib_bytes: int, copies_allowed: int = 0):
    """Run fn() and print its args/out/temp/peak bytes; fail when its temp
    holds more library-sized copies than allowed. Returns (out, row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_b = _nbytes(*_flat(out))
    temp = max(0, peak - out_b)
    arg_b = _nbytes(*args)
    log(f"[{tag}] args {arg_b / GIB:.2f} GB, out {out_b / GIB:.2f} GB, temp "
        f"{temp / GIB:.2f} GB, peak(args+out+temp) {(arg_b + out_b + temp) / GIB:.2f} GB")
    copies = temp / lib_bytes
    if copies >= copies_allowed + 0.9:
        raise AssertionError(
            f"{tag}: a temporary of {temp / GIB:.2f} GB holds {copies:.2f} library "
            f"copies (allowed {copies_allowed})"
        )
    return out, {"args_gb": arg_b / GIB, "out_gb": out_b / GIB, "temp_gb": temp / GIB,
                 "peak_gb": (arg_b + out_b + temp) / GIB, "lib_copies": copies}


def probe(dev, card: str = "", lp: int = LP, d: int = D, m: int = M,
          b: int = B_SLICE, k: int = K) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    lib = palette_rows(lp, d, gen)
    pick = torch.randint(0, lp, (b,), device=dev, generator=gen)
    noise = torch.randint(-6, 7, (b, d), device=dev, generator=gen)
    blocks = (lib[pick].int() + noise).clamp(0, 255).to(torch.uint8)
    del pick, noise
    torch.cuda.synchronize()
    lib_b = lib.numel()
    log(f"library [{lp}, {d}] u8 = {lib_b / 1e9:.2f} GB on the card, {b} blocks "
        f"[{card}]")
    rows = {}
    cand = torch.randint(0, lp, (b, m), dtype=torch.int32, device=dev, generator=gen)
    _, rows["A_l1_rows"] = measure("A_l1_rows (K3)", lambda: distance.l1_rows(blocks, cand, lib),
                                   (blocks, cand, lib), lib_b)
    del cand
    nseg = lp // distance._TL_SEG  # lp is a multiple of 128 here: lib is its own pad

    def coarse():
        cl = distance._ad_coarse_lib(lib, d, G, True, lp)
        return distance._ad_coarse(blocks, cl, d, G, True, CAP)

    (keys, s_min), rows["D_ad_coarse"] = measure("D_ad_coarse", coarse, (blocks, lib), lib_b)
    _, rows["C_ad_rescore"] = measure(
        "C_ad_rescore",
        lambda: distance._ad_rescore(blocks, keys, s_min, lib, m=m, k=k, real_l=lp),
        (blocks, keys, s_min, lib), lib_b,
    )
    del keys, s_min
    st = {}
    mm, cap = distance._ad_params(nseg)
    _, rows["W_l1_topk_adaptive"] = measure(
        f"W_l1_topk_adaptive (m={mm}, cap={cap})",
        lambda: distance.l1_topk_adaptive(blocks, lib, k, stats=st), (blocks, lib), lib_b,
        copies_allowed=1,
    )
    if st.get("route") != "adaptive":
        raise AssertionError(f"W took route {st.get('route')}, not the adaptive scorer")
    doubled = rows["W_l1_topk_adaptive"]["lib_copies"] >= 0.9
    log(f"W route {st['route']}, {st['certified']}/{b} certified, audit {st['audit']}; "
        f"_pad_lib's padded copy {'doubles' if doubled else 'does not double'} the "
        f"resident library ({rows['W_l1_topk_adaptive']['lib_copies']:.2f} library "
        f"copies of temp) [{card}]")
    log("A, D, C: no temporary of the library's size")
    del lib, blocks
    torch.cuda.empty_cache()
    return {"steps": rows, "pad_lib_doubles": doubled, "route": st["route"],
            "certified": st["certified"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("flatdma probe: needs a GPU", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    probe(torch.device("cuda", 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
