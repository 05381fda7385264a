"""Source kind: photos made from an image of `images/` (the repository's
example input), enlarged bilinearly by the least factor that covers the
configuration's photo and cropped to it; nothing is added to the image's
bytes.

Parameters: `image`, a name in `images/`. Pool photo k takes the
(k mod 8)-th of the image's 8 flips and quarter turns in an order drawn
from the seed, so every seed renders the same 8, and a crop offset drawn
from the seed.
"""

import math

import torch
import torch.nn.functional as F

from bench_torch.scene import image, u8


def dihedral(img: torch.Tensor, t: int) -> torch.Tensor:
    """The t-th (0..7) of img's flips and quarter turns."""
    if t & 4:
        img = img.transpose(0, 1)
    if t & 1:
        img = img.flip(0)
    if t & 2:
        img = img.flip(1)
    return img


def enlarge(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """img enlarged bilinearly to cover h x w."""
    h0, w0 = img.shape[:2]
    s = max(h / h0, w / w0)
    size = (max(h, math.ceil(h0 * s)), max(w, math.ceil(w0 * s)))
    x = img.permute(2, 0, 1)[None].float()
    big = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    return u8(big[0].permute(1, 2, 0).round())


def _offset(span: int, gen, dev) -> int:
    return int(torch.randint(0, span + 1, (1,), generator=gen, device=dev))


def pool(params, ctx, n):
    sz, gen, dev = ctx.sizes, ctx.gen, ctx.dev
    h, w = sz["height"], sz["width"]
    base = image(params["image"], ctx)
    order = torch.randperm(8, generator=gen, device=dev).tolist()
    out = []
    for k in range(n):
        big = enlarge(dihedral(base, order[k % 8]), h, w)
        oy = _offset(big.shape[0] - h, gen, dev)
        ox = _offset(big.shape[1] - w, gen, dev)
        out.append(big[oy : oy + h, ox : ox + w].contiguous())
    return out
