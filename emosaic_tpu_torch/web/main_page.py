"""Main HTML page generator (reference: src/mosaic/web/main_page.rs).

Wraps the standalone widget in an iframe page with a distance-overlay
toggle button + legend communicating via postMessage
(main_page.rs:202-239), followed by the statistics section.
"""

from __future__ import annotations

import html as html_mod
from pathlib import Path

from emosaic_tpu_torch.stats import MosaicConfig, RenderStats
from emosaic_tpu_torch.tiles.tileset import TileSet
from emosaic_tpu_torch.web.html_stats import stats_section_html
from emosaic_tpu_torch.web.widget import generate_mosaic_widget_with_options

_PAGE_STYLE = """
        body { font-family: Arial, sans-serif; margin: 0; padding: 20px; background-color: #f5f5f5; }
        .container { max-width: 100%; margin: 0 auto; background: white; padding: 20px; border-radius: 8px; box-shadow: 0 2px 4px rgba(0,0,0,0.1); }
        .mosaic-frame { margin: 20px 0; border: 1px solid #ddd; border-radius: 4px; overflow: hidden; background: white; }
        .mosaic-iframe { width: 100%; height: 80vh; border: none; display: block; }
        .stats { margin-top: 30px; padding: 20px; background: #f8f9fa; border-radius: 4px; }
        .stats h2 { margin-top: 0; color: #333; }
        .stats-grid { display: grid; grid-template-columns: repeat(auto-fit, minmax(300px, 1fr)); gap: 20px; margin-top: 20px; }
        .stats-section { background: white; padding: 15px; border-radius: 4px; border: 1px solid #ddd; }
        .stats-section h3 { margin-top: 0; color: #555; }
        .tile-info { display: flex; justify-content: space-between; padding: 5px 0; border-bottom: 1px solid #eee; }
        .tile-info:last-child { border-bottom: none; }
        .distance-good { color: #28a745; }
        .distance-medium { color: #ffc107; }
        .distance-bad { color: #dc3545; }
        .distance-toggle { margin: 10px 0; padding: 8px 16px; background: #007bff; color: white; border: none; border-radius: 4px; cursor: pointer; font-size: 14px; }
        .distance-toggle:hover { background: #0056b3; }
        .distance-legend { margin: 10px 0; padding: 10px; background: #f8f9fa; border-radius: 4px; font-size: 12px; display: none; }
        .distance-legend.visible { display: block; }
        .legend-item { display: inline-block; margin: 5px 10px 5px 0; }
        .legend-color { display: inline-block; width: 20px; height: 15px; margin-right: 5px; vertical-align: middle; border: 1px solid #ccc; }
        .overlay-distance-excellent { background: rgba(0, 255, 0, 0.8); }
        .overlay-distance-good { background: rgba(40, 167, 69, 0.8); }
        .overlay-distance-medium { background: rgba(255, 193, 7, 0.8); }
        .overlay-distance-poor { background: rgba(255, 152, 0, 0.8); }
        .overlay-distance-bad { background: rgba(220, 53, 69, 0.8); }
"""

_PAGE_SCRIPT = """
        function toggleDistanceOverlay() {
            const iframe = document.getElementById('mosaic-iframe');
            if (!iframe) return;
            iframe.contentWindow.postMessage({ type: 'toggleDistanceOverlay' }, '*');
        }
        window.addEventListener('message', function(event) {
            if (event.data && event.data.type === 'distanceOverlayToggled') {
                const legend = document.getElementById('distance-legend');
                const button = document.getElementById('distance-toggle-btn');
                if (legend && button) {
                    if (event.data.visible) {
                        legend.classList.add('visible');
                        button.textContent = 'Hide Distance Overlay';
                    } else {
                        legend.classList.remove('visible');
                        button.textContent = 'Show Distance Overlay';
                    }
                }
            }
        });
        window.toggleDistanceOverlay = toggleDistanceOverlay;
"""

_LEGEND = """
        <div id="distance-legend" class="distance-legend">
            <strong>Distance Legend:</strong>
            <div class="legend-item"><span class="legend-color overlay-distance-excellent"></span>Excellent (0-20%)</div>
            <div class="legend-item"><span class="legend-color overlay-distance-good"></span>Good (20-40%)</div>
            <div class="legend-item"><span class="legend-color overlay-distance-medium"></span>Medium (40-60%)</div>
            <div class="legend-item"><span class="legend-color overlay-distance-poor"></span>Poor (60-80%)</div>
            <div class="legend-item"><span class="legend-color overlay-distance-bad"></span>Bad (80-100%)</div>
        </div>
"""


def generate_html_with_options(
    stats: RenderStats,
    mosaic_image_path: Path,
    output_path: Path,
    tile_set: TileSet,
    config: MosaicConfig,
    web: bool = False,
) -> None:
    """Entry point matching main_page.rs:28-81: writes both
    `{stem}_widget.html` and the wrapping main page at `output_path`."""
    if not stats.tiles:
        raise ValueError("No tiles recorded in statistics")
    output_path = Path(output_path)
    mosaic_image_path = Path(mosaic_image_path)
    widget_path = output_path.with_name(f"{output_path.stem}_widget.html")
    generate_mosaic_widget_with_options(
        stats, mosaic_image_path, widget_path, tile_set, config, web
    )
    title = html_mod.escape(mosaic_image_path.name)
    page = f"""<!DOCTYPE html>
<html lang="en">
<head>
    <meta charset="UTF-8">
    <meta name="viewport" content="width=device-width, initial-scale=1.0">
    <title>Mosaic Visualization - {title}</title>
    <style>{_PAGE_STYLE}</style>
    <script>{_PAGE_SCRIPT}</script>
</head>
<body>
    <div class="container">
        <h1>Mosaic Visualization</h1>
        <p>Hover over any tile to see detailed information including distance score and source file. <strong>Click on any tile to open the original image in a new tab.</strong></p>

        <button id="distance-toggle-btn" class="distance-toggle" onclick="toggleDistanceOverlay()">Show Distance Overlay</button>
{_LEGEND}
        <div class="mosaic-frame">
            <iframe id="mosaic-iframe" class="mosaic-iframe" src="{html_mod.escape(widget_path.name)}" title="Interactive Mosaic Visualization"></iframe>
        </div>
{stats_section_html(stats, tile_set, config)}
    </div>
</body>
</html>"""
    output_path.write_text(page, encoding="utf-8")
