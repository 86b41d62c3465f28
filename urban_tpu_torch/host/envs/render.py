"""Matplotlib plan rendering (SVG export).

Replacement for the reference's GeoDataFrame.plot-based visualization
(reference: urban_planning/envs/city.py:571-619): draws plan polygons/lines/
points colored by land-use type, optionally saving SVG frames for videos.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from urban_tpu_torch.host import city_config


def plot_table(table, save_fig: bool = False, path: Optional[str] = None,
               legend: bool = True, ticks: bool = True, bbox: bool = True,
               show: bool = False) -> None:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon as MplPolygon

    fig, ax = plt.subplots(figsize=(8, 8))
    seen_types = set()
    for row in np.nonzero(table.existence)[0]:
        g = table.geoms[row]
        t = int(table.types[row])
        name = city_config.LAND_USE_ID_MAP_INV.get(t, 'outside') \
            if t != city_config.INTERSECTION else 'road'
        color = city_config.TYPE_COLOR_MAP.get(name, 'gray')
        seen_types.add(name)
        if g.is_poly:
            ax.add_patch(MplPolygon(g.coords, closed=True, facecolor=color,
                                    edgecolor='black', linewidth=0.3))
        elif g.is_line:
            ax.plot(g.coords[:, 0], g.coords[:, 1], color=color, linewidth=1.0)
        else:
            ax.plot(g.coords[0, 0], g.coords[0, 1], '.', color=color,
                    markersize=2)
    ax.autoscale_view()
    ax.set_aspect('equal')
    if legend:
        from matplotlib.lines import Line2D
        handles = [Line2D([0], [0], marker='s', linestyle='',
                          markerfacecolor=city_config.TYPE_COLOR_MAP.get(n, 'gray'),
                          markeredgecolor='black', label=n)
                   for n in sorted(seen_types)]
        ax.legend(handles=handles, bbox_to_anchor=(1.05, 1), loc='upper left')
    if not ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    if not bbox:
        ax.axis('off')
    if save_fig:
        assert path is not None
        fig.savefig(path, format='svg', transparent=True,
                    bbox_inches='tight')
    if show:
        plt.show()
    plt.close(fig)
