"""Library kind: tile images of a random base colour plus Gaussian `noise`
per pixel; each palette is the truncating box mean of its tile over the
mode's cell grid (the analysis of `ops/analysis.py`). A stand-in for a
library of photos (none ships with the repository); `noise` is chosen,
not measured."""

import torch

from bench_torch.scene import box_mean, u8


def library(params, ctx):
    sz, gen, dev = ctx.sizes, ctx.gen, ctx.dev
    t, ts = sz["T"], sz["ts"]
    base = torch.randint(0, 256, (t, 1, 1, 3), device=dev, generator=gen).float()
    noise = params["noise"] * torch.randn((t, ts, ts, 3), device=dev, generator=gen)
    stack = u8(base + noise)
    return box_mean(stack, sz["dim"]), stack
