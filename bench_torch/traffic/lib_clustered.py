"""Library kind: each palette a random base colour with +-`texture` per
cell, and the tile image its palette's cell grid. A stand-in for a library
of textured photos (none ships with the repository); `texture` is chosen,
not measured."""

import torch

from bench_torch.scene import u8, upscale


def library(params, ctx):
    sz, gen, dev = ctx.sizes, ctx.gen, ctx.dev
    t, dim, ts, n = sz["T"], sz["dim"], sz["ts"], sz["dim"] ** 2
    tex = params["texture"]
    base = torch.randint(0, 256, (t, 1, 3), device=dev, generator=gen)
    pal = u8(base + torch.randint(-tex, tex + 1, (t, n, 3), device=dev, generator=gen))
    return pal, upscale(pal.view(t, dim, dim, 3), ts)
