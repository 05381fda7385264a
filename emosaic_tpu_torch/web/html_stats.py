"""HTML statistics section (reference: src/mosaic/web/html_stats.rs).

Overview, full MosaicConfig dump, top-10 most used tiles, worst-10 matches
rendered as a stats grid (html_stats.rs:17-175).
"""

from __future__ import annotations

import html as html_mod

from emosaic_tpu_torch.stats import MosaicConfig, RenderStats
from emosaic_tpu_torch.tiles.tileset import TileSet


def _esc(s) -> str:
    return html_mod.escape(str(s), quote=True)


def _row(label: str, value: str, value_class: str = "") -> str:
    cls = f' class="{value_class}"' if value_class else ""
    return (
        '                    <div class="tile-info">\n'
        f"                        <span>{label}</span>\n"
        f"                        <span{cls}>{value}</span>\n"
        "                    </div>\n"
    )


def stats_section_html(
    stats: RenderStats, tile_set: TileSet, config: MosaicConfig
) -> str:
    total = sum(e.distance for e in stats.tiles.values())
    usage: dict[str, int] = {}
    for e in stats.tiles.values():
        p = str(tile_set.get_path(e.idx))
        usage[p] = usage.get(p, 0) + 1
    avg = total / len(stats.tiles) if stats.tiles else 0.0

    out = [
        """
        <div class="stats">
            <h2>Mosaic Statistics</h2>
            <div class="stats-grid">
                <div class="stats-section">
                    <h3>Overview</h3>
"""
    ]
    out.append(_row("Total tiles placed:", str(len(stats.tiles))))
    out.append(_row("Unique images used:", str(len(usage))))
    out.append(_row("Average distance:", f"{avg:.3f}"))
    out.append(
        """                </div>
                <div class="stats-section">
                    <h3>Configuration</h3>
"""
    )
    out.append(_row("Mode:", _esc(config.mode)))
    out.append(_row("Tile size:", f"{config.tile_size} px"))
    out.append(_row("No repeat:", "Yes" if config.no_repeat else "No"))
    out.append(_row("Greedy algorithm:", "Yes" if config.greedy else "No"))
    out.append(_row("Crop tiles:", "Yes" if config.crop else "No"))
    out.append(_row("Tint opacity:", f"{config.tint_opacity * 100.0:.1f}%"))
    out.append(_row("Downsample factor:", f"{config.downsample}x"))
    out.append(
        _row(
            "Randomization:",
            "None" if config.randomize is None else f"{config.randomize:.1f}%",
        )
    )
    out.append(_row("Tiles directory:", _esc(config.tiles_dir)))
    out.append(
        """                </div>
                <div class="stats-section">
                    <h3>Most Used Tiles</h3>
"""
    )
    by_count = sorted(usage.items(), key=lambda kv: (-kv[1], kv[0]))
    from pathlib import Path

    for i, (path, count) in enumerate(by_count[:10]):
        out.append(_row(f"{i + 1}. {_esc(Path(path).name)}", f"{count} times"))
    out.append(
        """                </div>
                <div class="stats-section">
                    <h3>Worst Matches</h3>
"""
    )
    worst = sorted(stats.tiles.items(), key=lambda kv: (-kv[1].distance, kv[0]))
    for i, (_, e) in enumerate(worst[:10]):
        name = tile_set.get_path(e.idx).name
        out.append(
            _row(f"{i + 1}. {_esc(name)}", f"{e.distance:.3f}", "distance-bad")
        )
    out.append(
        """                </div>
            </div>
        </div>
"""
    )
    return "".join(out)
