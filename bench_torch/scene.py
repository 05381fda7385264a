"""The one traffic generator: a cell's tile library and its pool of source
photos, made on the device from `--seed`.

A traffic mix (`traffic/<mix>.json`) names a library kind and a source kind
with their parameters. Each kind is a file of its own, `traffic/<kind>.py`,
found by its name:
- a library kind has `library(params, ctx)` -> (palettes [T, N, 3],
  stack [T, ts, ts, 3]), u8 on the device;
- a source kind has `pool(params, ctx, n)` -> n photos [H, W, 3], u8 on
  the device.
`ctx` carries the configuration's sizes (`sizes`), the seeded generator,
the device and the benchmark's folder (for `images/<name>.json`). The same
seed gives the same scene; every seed gives the same sizes.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from bench_torch import spec


@dataclass
class Scene:
    palettes: torch.Tensor  # [T, N, 3] u8 on the device
    stack: torch.Tensor  # [T, ts, ts, 3] u8 on the device
    sources: list  # P host [H, W, 3] u8 arrays
    dim: int
    tile_size: int

    @property
    def stack_host(self) -> np.ndarray:
        return self.stack.cpu().numpy()


def sizes(cfg: dict) -> dict:
    """The cell's shapes: blocks B on a gh x gw grid, library rows L = 2T,
    row width D, the photo's height and width and the output's pixels."""
    dim, ts = cfg["mode"], cfg["tile_size"]
    h, w = cfg["source_height"], cfg["source_width"]
    gh, gw = h // dim, w // dim
    return {"dim": dim, "ts": ts, "T": cfg["tiles"], "L": 2 * cfg["tiles"],
            "D": dim * dim * 3, "B": gh * gw, "gh": gh, "gw": gw, "height": h,
            "width": w, "out_pixels": gh * ts * gw * ts}


def upscale(cells: torch.Tensor, ts: int) -> torch.Tensor:
    """[T, dim, dim, 3] cell grids as [T, ts, ts, 3] images (nearest)."""
    dim = cells.shape[1]
    if ts == dim:
        return cells.contiguous()
    idx = torch.arange(ts, device=cells.device) * dim // ts
    return cells[:, idx][:, :, idx].contiguous()


def box_mean(tiles: torch.Tensor, dim: int) -> torch.Tensor:
    """[T, ts, ts, 3] u8 -> [T, dim*dim, 3] u8: int32 box sums over a dim x
    dim grid of floor(ts/dim) boxes, a truncating mean."""
    t, h, w = tiles.shape[:3]
    bh, bw = h // dim, w // dim
    x = tiles[:, : dim * bh, : dim * bw].to(torch.int32)
    sums = x.reshape(t, dim, bh, dim, bw, 3).sum(dim=(2, 4), dtype=torch.int32)
    return torch.div(sums, bh * bw, rounding_mode="trunc").to(torch.uint8).reshape(t, -1, 3)


def u8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0, 255).to(torch.uint8)


def image(name: str, ctx) -> torch.Tensor:
    """`images/<name>.json` as [h, w, 3] u8 on the device."""
    raw = spec.load_json(ctx.base / "images" / f"{spec.check_name(name, 'image')}.json")
    rgb = np.frombuffer(base64.b64decode(raw["rgb_base64"]), dtype=np.uint8)
    return torch.from_numpy(rgb.reshape(raw["height"], raw["width"], 3).copy()).to(ctx.dev)


def make_scene(cfg: dict, traffic: dict, seed: int, device, base: Path = spec.HERE) -> Scene:
    """The cell's library and its pool of `traffic["pool"]` sources, drawn in
    that order from one generator on `device` seeded with `seed`."""
    dev = torch.device(device)
    sz = sizes(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    ctx = SimpleNamespace(sizes=sz, gen=gen, dev=dev, base=Path(base))
    lib_kind = spec.load_module("traffic", traffic["library"]["kind"], base)
    src_kind = spec.load_module("traffic", traffic["sources"]["kind"], base)
    pal, stack = lib_kind.library(traffic["library"], ctx)
    pool = [p.cpu().numpy() for p in src_kind.pool(traffic["sources"], ctx, traffic["pool"])]
    return Scene(palettes=pal, stack=stack, sources=pool, dim=sz["dim"], tile_size=sz["ts"])
