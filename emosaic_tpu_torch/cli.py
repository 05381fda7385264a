"""Two-level CLI of the port, mirroring `emosaic_tpu.cli` (src/main.rs:28-155).

    emosaic-tpu-torch [-s TILE_SIZE] [-o OUTPUT] IMG [--crop] prepare
    emosaic-tpu-torch [-s TILE_SIZE] [-o OUTPUT] IMG [--crop] mosaic TILES_DIR
        [-m MODE] [-f] [-t TINT] [--downsample N] [--device {cuda,cpu}] ...

The parser is the JAX package's, flag for flag, plus `--device`. The
matched route (with `--randomize`, `--no-repeat --greedy`, `--matcher
{auto,lut,pallas,xla,hybrid}` and `--metric {l1,l2}`), the global
no-repeat route (`--no-repeat`, also with `--matcher hybrid`), `-m
random`, the tint route, the banded PNG route, the stats PNG, `--html` /
`--web`, `--profile` (on torch.profiler), `--mesh` (the sharded matchers
of `parallel/`) and multi-process runs under `EMOSAIC_DISTRIBUTED` (on
torch.distributed; rank 0 alone writes the outputs) run here. Parity
quirks kept: the output is always PNG-encoded (main.rs:482-483) and the
tint path returns before the stats and the HTML (main.rs:477).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from emosaic_tpu_torch.errors import ImageError
from emosaic_tpu_torch.io.discovery import find_images
from emosaic_tpu_torch.io.prep import cache_dir, prepare_tile
from emosaic_tpu_torch.modes import Mode
from emosaic_tpu_torch.monitor import (
    MemoryMonitor,
    PhaseTimer,
    Progress,
    print_runtime_stats,
)
from emosaic_tpu_torch.stats import MosaicConfig
from emosaic_tpu_torch.tiles.builder import load_or_generate_tile_set
from emosaic_tpu_torch.tiles.cache import (
    load_stack_cache,
    save_stack_cache,
    stack_cache_path,
)
from emosaic_tpu_torch.tiles.tileset import TileSet


def log(*a):
    print(*a, file=sys.stderr)


# ---------------------------------------------------------------------------
# validation (main.rs:141-155, :272-345)
# ---------------------------------------------------------------------------


def _between_zero_and_one(s: str) -> float:
    v = float(s)
    if not 0.0 <= v <= 1.0:
        raise argparse.ArgumentTypeError("Value must be between 0 and 1")
    return v


def _percentage(s: str) -> float:
    v = float(s)
    if not 0.0 <= v <= 100.0:
        raise argparse.ArgumentTypeError("Value must be between 0 and 100")
    return v


def _positive_int(s: str) -> int:
    """clap-u16 analogue: the reference cannot even represent 0/negative
    here without panicking deep in the resize; fail at the parser."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("Value must be a positive integer")
    return v


def validate_tile_size(tile_size: int) -> None:
    if tile_size <= 0:  # the reference's u32 makes negatives unrepresentable
        raise SystemExit(
            "❌ Tile size must be greater than 0\n"
            "💡 Try using a value like 16, 32, or 64"
        )
    if tile_size > 1024:
        raise SystemExit(
            "❌ Tile size is too large (maximum: 1024)\n"
            "💡 Large tile sizes require significant memory and processing time"
        )


_VALID_EXTS = ["jpg", "jpeg", "png", "bmp", "gif", "tiff", "webp"]


def validate_input_image(path: Path) -> None:
    if not path.exists():
        raise SystemExit(
            f"❌ Input image does not exist: {path}\n"
            "💡 Check the file path and ensure the file exists"
        )
    if not path.is_file():
        raise SystemExit(
            f"❌ Input path is not a file: {path}\n"
            "💡 Please provide a path to an image file, not a directory"
        )
    ext = path.suffix[1:].lower()
    if not ext:
        raise SystemExit(
            "❌ Input file has no extension\n"
            "💡 Please use an image file with a proper extension like .jpg or .png"
        )
    if ext not in _VALID_EXTS:
        raise SystemExit(
            f"❌ Unsupported image format: {path.suffix[1:]}\n"
            f"💡 Supported formats: {', '.join(_VALID_EXTS)}"
        )


def validate_tiles_directory(path: Path) -> None:
    if not path.exists():
        raise SystemExit(
            f"❌ Tiles directory does not exist: {path}\n"
            "💡 Create the directory and add image files to use as tiles"
        )
    if not path.is_dir():
        raise SystemExit(
            f"❌ Tiles path is not a directory: {path}\n"
            "💡 Please provide a path to a directory containing tile images"
        )


def validate_output_path(path: Path) -> None:
    parent = path.parent
    if parent and str(parent) != "":
        if not parent.exists():
            raise SystemExit(f"Output directory does not exist: {parent}")
        if not parent.is_dir():
            raise SystemExit(f"Output parent path is not a directory: {parent}")


# ---------------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------------


class _ExtendExtensions(argparse.Action):
    """clap `Vec<String>` append semantics (main.rs:100-104).

    The reference accepts one value per `--extensions` occurrence and
    accumulates across occurrences; argparse `nargs="*"` would make the
    last occurrence win. This action supports both spellings:
    `--extensions jpg png` and `--extensions jpg --extensions png`
    accumulate identically, and any occurrence replaces the default.
    """

    def __call__(self, parser, namespace, values, option_string=None):
        prior = getattr(namespace, self.dest, None)
        if prior is None or prior is self.default:
            prior = []
        setattr(namespace, self.dest, list(prior) + list(values))



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="emosaic-tpu-torch",
        description="Photomosaic generator on an NVIDIA GPU (the PyTorch/CUDA "
        "port of emosaic-tpu)",
    )
    p.add_argument(
        "-s",
        "--tile-size",
        type=int,
        default=16,
        help="The size of each tile in the output image",
    )
    p.add_argument(
        "-o",
        "--output-path",
        type=Path,
        default=Path("./output.jpg"),
        help="Output image path (always PNG-encoded, like the reference)",
    )
    p.add_argument("img", type=Path, help="Path to input image")
    p.add_argument(
        "--crop", action="store_true", help="Crop tiles instead of resizing"
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="Capture a torch.profiler trace of the run (host activity, and "
        "the card's with --device cuda) into DIR as a Chrome trace",
    )
    p.add_argument(
        "--fast-prep",
        action="store_true",
        help="Decode JPEG tiles at a reduced DCT scale during preparation "
        "(~4x faster cold library builds, <=1 LSB tile difference; exact "
        "and fast runs keep separate caches)",
    )
    sub = p.add_subparsers(dest="subcmd")

    sub.add_parser(
        "prepare",
        help="Convert an image into a tile (trim + resize), for testing",
    )

    m = sub.add_parser("mosaic", help="Generate a mosaic")
    m.add_argument("tiles_dir", type=Path, help="Directory containing tile images")
    m.add_argument(
        "-m",
        "--mode",
        choices=[md.value for md in Mode],
        default="1",
        help="Mosaic mode",
    )
    m.add_argument(
        "-f",
        "--force",
        action="store_true",
        help="Force re-analysis of tiles (ignore analysis cache)",
    )
    m.add_argument(
        "-t",
        "--tint-opacity",
        type=_between_zero_and_one,
        default=0.0,
        help="Opacity (0..1) of the source image overlaid on the output",
    )
    m.add_argument("--no-repeat", action="store_true", help="Avoid repeating tiles")
    m.add_argument(
        "--downsample",
        type=_positive_int,
        default=1,
        help="Downsampling factor applied to the original image",
    )
    m.add_argument(
        "--randomize",
        type=_percentage,
        default=None,
        help="Select one of the best tiles randomly (within x%% of the best)",
    )
    m.add_argument(
        "--extensions",
        # "+" not "*": clap's Vec<String> requires a value per occurrence
        # (main.rs:100-104); a bare --extensions must be rejected, not
        # silently empty the extension set (ADVICE r3)
        nargs="+",
        action=_ExtendExtensions,
        default=["jpg", "jpeg"],
        help="Extensions of image files in the tiles dir (case-sensitive); "
        "repeatable — occurrences accumulate (clap parity)",
    )
    m.add_argument(
        "--greedy",
        action="store_true",
        help="With no-repeat: faster, less accurate algorithm",
    )
    m.add_argument(
        "--html",
        action="store_true",
        help="Generate interactive HTML with tile tooltips",
    )
    m.add_argument(
        "--web",
        action="store_true",
        help="Web-compatible HTML with relative URLs for static hosting",
    )
    m.add_argument("--title", default="Mosaic Widget", help="HTML page title")
    m.add_argument("--seed", type=int, default=0, help="RNG seed (reproducible runs)")
    m.add_argument(
        "--matcher",
        choices=["auto", "lut", "pallas", "xla", "hybrid"],
        default="auto",
        help="Matching kernel selection; 'hybrid' = MXU L2 prefilter + "
        "exact-L1 rescore, the approximate fast mode for high-N modes "
        "(PARITY deviation; also accelerates --no-repeat scoring)",
    )
    m.add_argument(
        "--metric",
        choices=["l1", "l2"],
        default="l1",
        help="Color distance: l1 (exact reference parity) or l2 (MXU fast "
        "mode, performance addition)",
    )
    m.add_argument(
        "--stream-threshold",
        type=int,
        default=1 << 30,
        help="Output byte size above which the mosaic is composed in bands "
        "and PNG-encoded incrementally (gigapixel path)",
    )
    m.add_argument(
        "--max-stack-bytes",
        type=int,
        default=8 << 30,
        help="Tile-stack memory cap; beyond it the composite streams tiles "
        "from the disk cache (huge tile_size x library combos)",
    )
    m.add_argument(
        "--png-compress-level",
        type=int,
        choices=range(0, 10),
        metavar="0..9",
        default=1,
        help="zlib level for streamed PNG output (0 = stored, fastest)",
    )
    m.add_argument(
        "--mesh",
        default="off",
        metavar="SPEC",
        help="multi-device mesh for matching/scoring: 'off' (single "
        "device), 'auto' (all devices, data-parallel), 'N' (N devices, "
        "data-parallel) or 'DxM' (D data x M library shards). Sharded "
        "results are bit-identical to single-device. Applies to the "
        "exact-L1 matchers; lut/hybrid/l2 matchers stay single-device. "
        "With --device cuda the devices are the GPUs of every process; "
        "with --device cpu the mesh is virtual on the one CPU device (any "
        "DxM, 'auto' = one position per process)",
    )
    m.add_argument(
        "--stats-json",
        metavar="PATH",
        default=None,
        help="also write the run statistics as JSON (totals, top-10 used, "
        "worst-10 matches, config snapshot) for pipeline consumers",
    )
    m.add_argument(
        "--png-filter",
        choices=("none", "sub", "up"),
        default="sub",
        help="PNG scanline filter for streamed output (sub/up compress "
        "photographic mosaics ~11%% smaller than none at ~same speed)",
    )
    m.add_argument(
        "--png-workers",
        type=int,
        default=None,
        metavar="N",
        help="parallel PNG compression threads (default: min(16, cpus); "
        "output bytes are identical for any worker count)",
    )
    m.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="torch device for analysis, matching and composite; 'cuda' "
        "raises when no GPU is visible, it never falls back to the CPU",
    )
    return p


# ---------------------------------------------------------------------------
# device, and the multi-device mesh (--mesh)
# ---------------------------------------------------------------------------


def resolve_device(name: str):
    """`--device` -> torch.device. 'cuda' without a visible GPU raises:
    the port never carries on silently on the CPU."""
    import torch

    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is visible to torch "
                f"(torch {torch.__version__}); pass --device cpu explicitly "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")


def _parse_mesh(spec: str, log, device):
    """Resolve a --mesh spec to a ("data", "model") Mesh, or None.

    'off' -> None; 'auto' -> all visible devices, data-parallel;
    'N' -> N devices data-parallel; 'DxM' -> D data x M library shards.
    A 1-device resolution returns None (the single-device kernels are the
    same computation without the shard plumbing). On `cuda` the visible
    devices are this process's GPUs times the processes; on the CPU the
    mesh is virtual on the one CPU device (any size; 'auto' is one
    position per process).
    """
    spec = spec.strip().lower()
    if spec == "off":
        return None
    import torch

    from emosaic_tpu_torch.parallel import distributed, make_mesh

    cuda = device.type == "cuda"
    avail = (torch.cuda.device_count() if cuda else 1) * distributed.world_size()
    if spec == "auto":
        data, model = avail, 1
    else:
        parts = spec.split("x")
        try:
            if len(parts) == 1:
                data, model = int(parts[0]), 1
            elif len(parts) == 2:
                data, model = int(parts[0]), int(parts[1])
            else:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"❌ Invalid --mesh '{spec}': expected off, auto, N, or DxM"
            ) from None
    n = data * model
    if cuda and n > avail:
        raise SystemExit(
            f"❌ --mesh {spec} needs {n} devices but only {avail} are visible"
        )
    if n <= 1:
        return None
    mesh = make_mesh(n, model=model, devices=None if cuda else [device] * n)
    log(f"🕸  Matching on a {data}x{model} (data x model) device mesh")
    return mesh


def _write_rank() -> bool:
    """Host file I/O under EMOSAIC_DISTRIBUTED: every rank computes, one
    rank writes. Always True outside a multi-process run."""
    if not os.environ.get("EMOSAIC_DISTRIBUTED"):
        return True
    from emosaic_tpu_torch.parallel.distributed import is_rank0

    return is_rank0()


# ---------------------------------------------------------------------------
# source preprocessing (main.rs:567-615)
# ---------------------------------------------------------------------------


def preprocess_source(original, downsample: int, dim: int) -> np.ndarray:
    """Downsample, round dims to the nearest multiple of dim (up when the
    remainder exceeds dim/2 — main.rs:574-585), Lanczos resize."""
    from PIL import Image

    nwidth = original.width // downsample
    nheight = original.height // downsample
    wmod = nwidth % dim
    nwidth = nwidth + (dim - wmod) if wmod > dim // 2 else nwidth - wmod
    hmod = nheight % dim
    nheight = nheight + (dim - hmod) if hmod > dim // 2 else nheight - hmod
    log(
        f"Resizing source image from {original.width}x{original.height} "
        f"to {nwidth}x{nheight}"
    )
    resized = original.resize((nwidth, nheight), Image.LANCZOS)
    return np.asarray(resized.convert("RGB"), dtype=np.uint8)


def get_image_stack(
    tile_set: TileSet,
    tiles_dir: Path,
    tile_size: int,
    max_bytes: int = 8 << 30,
) -> np.ndarray | None:
    """Prepared-tile stack with its persistent cache; None when the dense
    stack would exceed `max_bytes` (the composite then streams tiles from
    the disk cache)."""
    if len(tile_set) * tile_size * tile_size * 3 > max_bytes:
        log(
            "⚠️  Tile stack too large for memory; compositing will stream "
            "tiles from the disk cache"
        )
        return None
    spath = stack_cache_path(tiles_dir, tile_size)
    cached = load_stack_cache(spath, tile_set.paths)
    if cached is not None:
        return cached
    pb = Progress(len(tile_set), "Preparing tile stack")
    stack = tile_set.image_stack(tile_size, progress=pb)
    try:
        save_stack_cache(spath, tile_set.paths, stack)
    except OSError:
        pass  # non-fatal, like the stats-image save (main.rs:498-507)
    return stack


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def run_prepare(args) -> None:
    from PIL import Image

    tile = prepare_tile(args.img, args.tile_size, args.crop)
    if _write_rank():
        Image.fromarray(tile).save(args.output_path)


def run_matched(args, original, mode, device, timer):
    """The matched and no-repeat routes. Returns (output, items, stats,
    tile_set, stack, streaming, config)."""
    from emosaic_tpu_torch.render.matched import render_nto1
    from emosaic_tpu_torch.render.norepeat import render_nto1_no_repeat

    dim = mode.dim
    src = preprocess_source(original, args.downsample, dim)
    if src.shape[0] % dim or src.shape[1] % dim:
        log(
            f"Invalid source dimensions ({src.shape[1]}x{src.shape[0]}): "
            f"Dimensions must be divisible by {dim}"
        )
        raise SystemExit(1)
    if args.tile_size % dim:
        log(f"Invalid tile size: Tile size must be divisible by {dim}")
        raise SystemExit(1)
    with timer.phase("tile analysis (cache/generate)"):
        tile_set = load_or_generate_tile_set(
            args.tiles_dir,
            args.tile_size,
            set(args.extensions),
            args.crop,
            dim,
            force=args.force,
            progress=Progress(0, "Analysing tiles"),
            device=device,
        )
    log(f"Tile set with {len(tile_set)} tiles")
    with timer.phase("tile stack (cache/prepare)"):
        stack = get_image_stack(
            tile_set, args.tiles_dir, args.tile_size,
            max_bytes=args.max_stack_bytes,
        )
    # 'pallas' and 'xla' name the JAX package's two exact argmins; both
    # are K1 here, as both are the non-LUT exact argmin there
    use_lut = {
        "auto": "auto",
        "lut": "always",
        "pallas": "never",
        "xla": "never",
        "hybrid": "auto",
    }[args.matcher]
    hybrid = args.matcher == "hybrid"
    mesh = _parse_mesh(args.mesh, log, device)
    # gigapixel outputs are composed in bands and PNG-encoded
    # incrementally; stack=None (too big for memory) always streams
    out_h = (src.shape[0] // dim) * args.tile_size
    out_w = (src.shape[1] // dim) * args.tile_size
    streaming = out_h * out_w * 3 > args.stream_threshold or stack is None
    with timer.phase("match + compose"):
        if args.no_repeat and not args.greedy:
            dropped = [
                n
                for n, off in (
                    ("--randomize", args.randomize is None),
                    (f"--metric {args.metric}", args.metric == "l1"),
                    (f"--matcher {args.matcher}", args.matcher in ("auto", "hybrid")),
                )
                if not off
            ]
            if dropped:
                # the reference drops these silently on this route
                # (main.rs:663-666 passes neither randomize nor a matcher
                # choice to render_nto1_no_repeat); warn like the greedy
                # branch does (render/matched.py)
                log(
                    f"⚠️  {', '.join(dropped)} ignored: global "
                    "no-repeat always scores with the exact L1 top-k"
                )
            result = render_nto1_no_repeat(
                src, tile_set, args.tile_size, device=device, stack=stack,
                compose=not streaming,
                scorer="hybrid" if hybrid else "exact",
                mesh=mesh,
            )
        else:
            result = render_nto1(
                src,
                tile_set,
                args.tile_size,
                no_repeat=args.no_repeat,
                randomize=args.randomize,
                seed=args.seed,
                device=device,
                use_lut=use_lut,
                metric=args.metric,
                hybrid=hybrid,
                stack=stack,
                compose=not streaming,
                mesh=mesh,
            )
    result.stats.summarise(tile_set)
    output = result.image
    items = result.items
    stats = result.stats
    tile_set_out = result.tile_set
    config = MosaicConfig(
        tile_size=args.tile_size,
        mode=mode.label,
        no_repeat=args.no_repeat,
        greedy=args.greedy,
        crop=args.crop,
        tint_opacity=args.tint_opacity,
        downsample=args.downsample,
        randomize=args.randomize,
        tiles_dir=str(args.tiles_dir),
        title=args.title,
    )
    return output, items, stats, tile_set_out, stack, streaming, config


def run_random(args, original, device):
    """`-m random` (main.rs:415-435): every discovered tile, prepared
    square-cropped; one random tile per source pixel at full resolution.
    Returns (output or None, items or None, tile_set, stack, streaming)."""
    from emosaic_tpu_torch.render.random_mode import random_items, render_random

    images = find_images(args.tiles_dir, set(args.extensions))
    # the reference pushes every path unchecked and panics at render time
    # on an unreadable or undersized file (rendering.rs:430-433); here
    # those tiles are skipped with a warning, as in the JAX package
    keep_stack = len(images) * args.tile_size**2 * 3 <= args.max_stack_bytes
    good, prepared = [], []
    for p in images:
        try:
            img = prepare_tile(p, args.tile_size, crop=True)
            if keep_stack:
                prepared.append(img)
            good.append(p)
        except ImageError as e:
            log(f"- skipping {e}")
    if not good:
        raise SystemExit("❌ No usable tiles found")
    tile_set = TileSet(palettes=None, paths=good)
    log(f"Tile set with {len(tile_set)} tiles")
    src = np.asarray(original.convert("RGB"), dtype=np.uint8)
    stack = np.stack(prepared) if keep_stack else None
    out_h = src.shape[0] * args.tile_size
    out_w = src.shape[1] * args.tile_size
    streaming = out_h * out_w * 3 > args.stream_threshold or stack is None
    if streaming:
        items = random_items(src.shape[:2], len(tile_set), args.seed)
        return None, items, tile_set, stack, streaming
    output = render_random(
        src, tile_set, args.tile_size, seed=args.seed, stack=stack, device=device
    )
    return output, None, tile_set, stack, streaming


def run_mosaic(args, timer=None) -> None:
    from PIL import Image

    from emosaic_tpu_torch.ops.composite import stream_tinted_bands, tint_blend

    timer = timer or PhaseTimer(log)
    device = resolve_device(args.device)
    validate_tiles_directory(args.tiles_dir)
    mode = Mode(args.mode)
    log(f"Opening source image: {args.img}")
    try:
        original = Image.open(args.img)
    except Exception as e:  # corrupt/garbage bytes behind a valid extension
        raise SystemExit(f"❌ Failed to open source image {args.img}: {e}")

    if mode is Mode.RANDOM:
        output, items, tile_set_out, stack, streaming = run_random(args, original, device)
        stats = config = None
    else:
        output, items, stats, tile_set_out, stack, streaming, config = run_matched(
            args, original, mode, device, timer
        )

    out_path = args.output_path
    if not _write_rank():
        # a multi-process run (EMOSAIC_DISTRIBUTED): every rank computed the
        # same result over the mesh; the outputs belong to rank 0 alone
        log("🛰  compute done on this rank; rank 0 writes the outputs")
        return
    original_rgb = None
    if args.tint_opacity > 0.0:
        # the tint overlay is the *original* source at full resolution
        # (main.rs:450), not the downsampled one
        original_rgb = np.asarray(original.convert("RGB"), dtype=np.uint8)

    if streaming:
        from emosaic_tpu_torch.io.codecs import StreamingPNGWriter

        nby, nbx = items.shape
        out_w = nbx * args.tile_size
        out_h = nby * args.tile_size
        log(f"📝 Streaming {out_w}x{out_h} output to {out_path}")
        with timer.phase("stream compose+encode"), StreamingPNGWriter(
            out_path,
            out_w,
            out_h,
            compress_level=args.png_compress_level,
            filter_type=args.png_filter,
            workers=args.png_workers,
        ) as w:
            for band in stream_tinted_bands(
                items,
                tile_set_out,
                stack,
                args.tile_size,
                original_rgb=original_rgb,
                tint_opacity=args.tint_opacity,
                device=device,
            ):
                w.write_band(band)
        if args.tint_opacity > 0.0:
            return  # tint path skips stats/HTML (main.rs:477 quirk)
    elif args.tint_opacity > 0.0:
        # tint path: blend, save, early return — skips stats/HTML
        # (main.rs:447-478 quirk preserved)
        blended = tint_blend(output, original_rgb, args.tint_opacity, device=device)
        Image.fromarray(blended).save(out_path, format="PNG")
        return
    else:
        log("✓ Mosaic generation completed successfully")
        log(f"📝 Writing output file to {out_path}")
        Image.fromarray(output).save(out_path, format="PNG")

    # random mode records no stats (stats is None)
    have_stats = stats is not None and stats.tile_count()
    if (stats is not None and not stats.tile_count()) and (
        args.stats_json or args.html or args.web
    ):
        # zero placements (e.g. a fully-starved assignment): stats.render
        # and the HTML generator would raise; say why the artifacts are
        # skipped instead of silently dropping or crashing
        log("⚠️  No tiles recorded in statistics; skipping stats/HTML outputs")
    if have_stats:
        stats_path = out_path.with_suffix(".stats.png")
        log(f"📊 Writing statistics visualization to {stats_path}")
        try:
            Image.fromarray(stats.render(args.tile_size)).save(
                stats_path, format="PNG"
            )
            log("📊 Statistics file saved (shows tile matching quality)")
        except OSError as e:
            log(f"⚠️  Failed to save statistics image to {stats_path}: {e}")
        if args.stats_json:
            import json

            try:
                Path(args.stats_json).write_text(
                    json.dumps(stats.to_dict(tile_set_out, config), indent=1)
                )
                log(f"📊 Statistics JSON saved to {args.stats_json}")
            except OSError as e:  # non-fatal, like the image save
                log(f"⚠️  Failed to save statistics JSON: {e}")

    if have_stats and (args.html or args.web):
        from emosaic_tpu_torch.web import generate_html_with_options

        html_path = out_path.with_suffix(".html")
        log(f"📄 Generating interactive HTML at {html_path}")
        generate_html_with_options(
            stats, out_path, html_path, tile_set_out, config, web=args.web
        )
        log("📄 Interactive HTML file saved (hover over tiles for details)")

    log(f"🎉 All done! Your mosaic is ready at {out_path}")


def _start_profiler(args):
    """Start torch.profiler for `--profile DIR`: host activity always, the
    card's when the run's device is cuda (CUPTI sees the hand-written
    kernels launched through ctypes as well)."""
    from torch.profiler import ProfilerActivity, profile

    Path(args.profile).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if getattr(args, "device", None) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def main(argv=None) -> int:
    start = time.time()
    monitor = MemoryMonitor().start()
    timer = PhaseTimer(log)
    prev_fast = os.environ.get("EMOSAIC_FAST_PREP")
    try:
        args = build_parser().parse_args(argv)
        validate_tile_size(args.tile_size)
        validate_input_image(args.img)
        validate_output_path(args.output_path)
        if args.fast_prep:
            # env-var backed so spawn-context prep workers and every cache
            # path helper see the same mode; restored on exit
            os.environ["EMOSAIC_FAST_PREP"] = "1"
        if os.environ.get("EMOSAIC_DISTRIBUTED"):
            # join the multi-process run before the first device op; the
            # mesh then spans every process and rank 0 alone writes
            from emosaic_tpu_torch.parallel.distributed import init_distributed

            init_distributed()
        cache_dir().mkdir(parents=True, exist_ok=True)
        profiler = _start_profiler(args) if args.profile else None
        try:
            if args.subcmd == "prepare":
                run_prepare(args)
            elif args.subcmd == "mosaic":
                run_mosaic(args, timer=timer)
            # no subcommand: validate-only, like the reference's `None => ()`
        finally:
            if profiler is not None:
                profiler.stop()
                profiler.export_chrome_trace(
                    str(Path(args.profile) / f"emosaic_{os.getpid()}.pt.trace.json")
                )
                log(f"🔬 Profiler trace written to {args.profile}")
        return 0
    finally:
        if prev_fast is None:
            os.environ.pop("EMOSAIC_FAST_PREP", None)
        else:
            os.environ["EMOSAIC_FAST_PREP"] = prev_fast
        timer.report()
        print_runtime_stats(start, monitor)
        monitor.stop()


if __name__ == "__main__":
    sys.exit(main())
