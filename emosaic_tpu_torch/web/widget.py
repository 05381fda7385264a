"""Standalone mosaic widget HTML generator
(reference: src/mosaic/web/widget.rs).

Feature parity:
- copies `mosaic-widget.{css,js}` next to the output with cache-busting
  `?v=timestamp` (widget.rs:107-124, :136-159);
- year range from tile EXIF dates (widget.rs:46-60);
- image dims inferred as `max_key + tile_size` (widget.rs:69-72 — only
  geometrically consistent with the no-repeat renderer's output-pixel stats
  coords, quirk preserved);
- per-tile distance-overlay div with 5-bucket quality class
  (widget.rs:203-218);
- interactive `.tile-region` divs with lazy tooltip image, distance info
  (hidden in web mode, widget.rs:335-341), EXIF date, year data-attr,
  sha256-prefix(16) tile hash for flagging (widget.rs:345-349), flag button;
- tile URLs: web mode `tiles/<relpath under tiles_dir>`, local mode
  `file://` absolute path (widget.rs:276-321);
- year-filter slider + mobile modal markup (widget.rs:394-429).
"""

from __future__ import annotations

import hashlib
import html as html_mod
import shutil
import time
from pathlib import Path

from emosaic_tpu_torch.stats import MosaicConfig, RenderStats
from emosaic_tpu_torch.tiles.tileset import TileSet

_ASSETS_DIR = Path(__file__).parent / "assets"


def _esc(s: str) -> str:
    return html_mod.escape(str(s), quote=True)


def _overlay_class(normalized: float) -> str:
    if normalized < 0.20:
        return "overlay-distance-excellent"
    if normalized < 0.40:
        return "overlay-distance-good"
    if normalized < 0.60:
        return "overlay-distance-medium"
    if normalized < 0.80:
        return "overlay-distance-poor"
    return "overlay-distance-bad"


def _distance_class(normalized: float) -> str:
    # widget.rs:260-273: <0.4 good, <0.6 medium, else bad
    if normalized < 0.40:
        return "distance-good"
    if normalized < 0.60:
        return "distance-medium"
    return "distance-bad"


def extract_year_range(stats: RenderStats) -> tuple[int, int]:
    """Year bounds from the placed tiles' EXIF dates (widget.rs:46-60)."""
    years = set()
    for e in stats.tiles.values():
        if e.date_taken:
            head = e.date_taken.split(":")[0]
            try:
                years.add(int(head))
            except ValueError:
                pass
    if not years:
        return 2000, 2030
    return min(years), max(years)


def copy_assets(output_path: Path) -> None:
    out_dir = output_path.parent if output_path.parent != Path("") else Path(".")
    for name in ("mosaic-widget.css", "mosaic-widget.js"):
        shutil.copyfile(_ASSETS_DIR / name, out_dir / name)


def generate_mosaic_widget_with_options(
    stats: RenderStats,
    mosaic_image_path: Path,
    output_path: Path,
    tile_set: TileSet,
    config: MosaicConfig,
    web_compatible: bool,
) -> None:
    if not stats.tiles:
        raise ValueError("No tiles recorded in statistics")
    mosaic_image_path = Path(mosaic_image_path)
    output_path = Path(output_path)
    min_year, max_year = extract_year_range(stats)
    copy_assets(output_path)
    ts = int(time.time())
    tile_size = config.tile_size

    max_x = max(x for x, _ in stats.tiles)
    max_y = max(y for _, y in stats.tiles)
    image_width = max_x + tile_size
    image_height = max_y + tile_size

    dists = [e.distance for e in stats.tiles.values()]
    dmin, dmax = min(dists), max(dists)
    drange = dmax - dmin

    def norm(d: float) -> float:
        return (d - dmin) / drange if drange > 0 else 0.0

    parts: list[str] = []
    parts.append(
        f"""<!DOCTYPE html>
<html lang="en">
<head>
    <meta charset="UTF-8">
    <meta name="viewport" content="width=device-width, initial-scale=1.0, maximum-scale=1.0, user-scalable=no, viewport-fit=cover">
    <meta name="apple-mobile-web-app-capable" content="yes">
    <meta name="apple-mobile-web-app-status-bar-style" content="black-translucent">
    <meta name="apple-mobile-web-app-title" content="{_esc(config.title)}">
    <meta name="mobile-web-app-capable" content="yes">
    <title>{_esc(config.title)}</title>
    <link rel="stylesheet" href="mosaic-widget.css?v={ts}">
    <script>
        var yearFilterMinYear = {min_year};
        var yearFilterMaxYear = {max_year};
    </script>
    <script src="mosaic-widget.js?v={ts}" defer></script>
</head>
<body>
    <div class="mosaic-container">
        <div class="zoom-container">
            <img src="{_esc(mosaic_image_path.name)}" alt="Mosaic Image" class="mosaic-image" />
            <div id="distance-overlay" class="distance-overlay">
"""
    )

    # deterministic emission order (the reference iterates a HashMap)
    items = sorted(stats.tiles.items(), key=lambda kv: (kv[0][1], kv[0][0]))

    for (x, y), e in items:
        lp = x / image_width * 100.0
        tp = y / image_height * 100.0
        wp = tile_size / image_width * 100.0
        hp = tile_size / image_height * 100.0
        parts.append(
            f'            <div class="distance-overlay-tile {_overlay_class(norm(e.distance))}"'
            f' style="left: {lp:.2f}%; top: {tp:.2f}%; width: {wp:.2f}%; height: {hp:.2f}%;"></div>\n'
        )
    parts.append("            </div>\n")

    tiles_dir = Path(config.tiles_dir)
    for (x, y), e in items:
        lp = x / image_width * 100.0
        tp = y / image_height * 100.0
        wp = tile_size / image_width * 100.0
        hp = tile_size / image_height * 100.0
        tile_path = tile_set.get_path(e.idx)
        if web_compatible:
            try:
                rel = tile_path.relative_to(tiles_dir)
            except ValueError:
                rel = Path(tile_path.name)
            url = f"tiles/{rel}"
            click_url, tooltip_url = url, url
        else:
            abs_path = tile_path if tile_path.is_absolute() else Path.cwd() / tile_path
            click_url = str(tile_path)
            tooltip_url = f"file://{abs_path}"
        # distance shown only in local mode (widget.rs:335-341)
        distance_info = (
            ""
            if web_compatible
            else f'<span class="{_distance_class(norm(e.distance))}">'
            f"Distance: {e.distance:.3f}</span><br/>"
        )
        date_info = e.date_taken or ""
        year = "unknown"
        if e.date_taken:
            head = e.date_taken.split(":")[0]
            year = head if head.isdigit() else "unknown"
        # sha256-prefix(16) of the path string for the flag API (widget.rs:345-349)
        tile_hash = hashlib.sha256(str(tile_path).encode()).hexdigest()[:16]
        parts.append(
            f"""
        <div class="tile-region" style="left: {lp:.2f}%; top: {tp:.2f}%; width: {wp:.2f}%; height: {hp:.2f}%;"
             data-click-url="{_esc(click_url)}"
             data-tile-image="{_esc(tooltip_url)}"
             data-distance-info="{_esc(distance_info)}"
             data-date-info="{_esc(date_info)}"
             data-year="{year}"
             data-tile-hash="{tile_hash}"
             data-tile-path="{_esc(str(tile_path))}">
            <div class="tooltip">
                <img data-src="{_esc(tooltip_url)}" alt="Tile Preview" class="tooltip-image" onerror="this.style.display='none'" style="display:none"/><br/>
                {distance_info}
                {_esc(date_info)}
                <div class="flag-status" id="flag-status-{tile_hash}"></div>
                <button class="flag-button" id="flag-btn-{tile_hash}">🚩 Flag for Review</button>
            </div>
        </div>"""
        )

    parts.append(
        f"""
        </div>

        <!-- Year filter: a fixed bottom pill here (the reference's
             .image-positioned absolute box, widget.rs:399, is a recorded
             styling deviation; the id stays as the stable DOM handle) -->
        <div id="year-filter-container" class="year-filter-container">
            <label for="year-slider" class="year-filter-label">Year:</label>
            <div class="year-slider-wrapper">
                <input type="range" id="year-slider" class="year-slider"
                       min="{min_year}" max="{max_year + 1}" value="{max_year + 1}" step="1" />
                <div id="year-display" class="year-display">All Years</div>
            </div>
        </div>
    </div>

    <!-- Mobile Modal -->
    <div id="mobile-modal" class="mobile-modal">
        <div class="modal-content">
            <button class="modal-close" onclick="closeMobileModal()">&times;</button>
            <img id="modal-image" class="modal-image" alt="Tile Image" />
            <div id="modal-info" class="modal-info"></div>
        </div>
    </div>

</body>
</html>"""
    )
    output_path.write_text("".join(parts), encoding="utf-8")
