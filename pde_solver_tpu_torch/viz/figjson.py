"""Plotly-compatible figure JSON + standalone HTML writer (no plotly dep).

The reference renders through the plotly Python package with
``include_plotlyjs="cdn"`` (fenics_mcp_server.py:4111-4117, :3172) — the
actual rendering always happens in the browser via plotly.js.  This module
builds the same figure JSON directly (plain dicts) and emits a standalone
HTML document that loads plotly.js from the CDN, adds animation frames, and
injects the enlarged-modebar CSS the reference uses (:4119-4133).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

PLOTLY_CDN = "https://cdn.plot.ly/plotly-2.35.2.min.js"

_MODEBAR_CSS = """
<style>
.modebar-btn svg {
    width: 28px;
    height: 28px;
}
.modebar {
    font-size: 16px;
}
</style>
"""

_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>{title}</title>
<script src="{cdn}"></script>
{css}
</head>
<body>
<div id="pde-plot" class="plotly-graph-div" style="height:95vh; width:100%;"></div>
<script type="text/javascript">
var fig = {fig_json};
var config = {config_json};
Plotly.newPlot("pde-plot", fig.data, fig.layout, config).then(function (gd) {{
    if (fig.frames && fig.frames.length > 0) {{
        Plotly.addFrames(gd, fig.frames);
    }}
}});
</script>
</body>
</html>
"""


class _NumpyEncoder(json.JSONEncoder):
    def default(self, obj):  # noqa: D102
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating,)):
            v = float(obj)
            return None if not np.isfinite(v) else v
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.bool_,)):
            return bool(obj)
        return super().default(obj)


def _sanitize(o):
    """Replace non-finite floats with None (plotly.js treats null as gap)."""
    if isinstance(o, float):
        return o if np.isfinite(o) else None
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    if isinstance(o, np.ndarray):
        if o.dtype.kind == "f":
            o = np.where(np.isfinite(o), o, np.nan)
            return [None if (isinstance(v, float) and not np.isfinite(v)) else v
                    for v in o.tolist()]
        return o.tolist()
    return o


def animation_controls(times: np.ndarray, frame_names: List[str],
                       duration_ms: int = 50) -> Dict[str, Any]:
    """Play/Pause buttons + time slider (layout fragment), matching the
    reference controls (fenics_mcp_server.py:3685-3755 and analogs)."""
    return {
        "updatemenus": [{
            "type": "buttons",
            "showactive": True,
            "x": 1.10, "y": 1.15, "xanchor": "right", "yanchor": "top",
            "buttons": [
                {"label": "Play", "method": "animate",
                 "args": [None, {"frame": {"duration": duration_ms, "redraw": True},
                                 "fromcurrent": True,
                                 "transition": {"duration": 0}}]},
                {"label": "Pause", "method": "animate",
                 "args": [[None], {"frame": {"duration": 0, "redraw": False},
                                   "mode": "immediate",
                                   "transition": {"duration": 0}}]},
            ],
        }],
        "sliders": [{
            "active": 0,
            "pad": {"t": 50},
            "currentvalue": {"prefix": "Time: "},
            "steps": [
                {"args": [[name], {"frame": {"duration": 0, "redraw": True},
                                   "mode": "immediate",
                                   "transition": {"duration": 0}}],
                 "label": f"{t:.3f}",
                 "method": "animate"}
                for t, name in zip(times, frame_names)
            ],
        }],
    }


def write_figure_html(
    data: List[Dict[str, Any]],
    layout: Dict[str, Any],
    frames: Optional[List[Dict[str, Any]]],
    output_dir: str,
    filename: str,
    title: str = "PDE field",
) -> str:
    """Serialize a figure to a standalone HTML file; returns the path."""
    fig = {"data": _sanitize(data), "layout": _sanitize(layout),
           "frames": _sanitize(frames or [])}
    config = {"displaylogo": False, "scrollZoom": True, "displayModeBar": True,
              "responsive": True}
    html = _HTML_TEMPLATE.format(
        title=title,
        cdn=PLOTLY_CDN,
        css=_MODEBAR_CSS,
        fig_json=json.dumps(fig, cls=_NumpyEncoder),
        config_json=json.dumps(config),
    )
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / filename
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(html)
    return str(out_path)
