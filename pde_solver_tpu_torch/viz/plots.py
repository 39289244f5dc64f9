"""Animated field plots: 1D line / 2D surface / 3D volume + cylindrical and
spherical specializations.

Behavior parity with the reference plotting subsystem
(fenics_mcp_server.py:2764-4140): same routing cascade
(metadata-first cylinder detection, then geometry params, then lenient
coordinate statistics — :3475-3541), same trace types (Scatter / Surface /
Volume), same animation controls, same 20×15×15 / 15³ resampling grids and
≤30-frame cap for the specialized 3D plotters (:2965-2971, :3042-3048,
:3201), same domain-bounds and aspect-ratio policies (:3839-3862).

Performance: the spatial interpolation structure is built once per plot and
reused across frames (the reference re-triangulates every frame,
:3803-3807, :3980-3984).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from pde_solver_tpu_torch.fields import PlotResult, load_field
from pde_solver_tpu_torch.viz.figjson import animation_controls, write_figure_html
from pde_solver_tpu_torch.viz.resample import FieldResampler


# ----------------------------------------------------------------------
# Specialized 3D plotters
# ----------------------------------------------------------------------

_MAX_3D_FRAMES = 30  # reference cap (fenics_mcp_server.py:3042-3048)


def _frame_indices(nt: int, cap: int = _MAX_3D_FRAMES) -> np.ndarray:
    if nt > cap:
        return np.linspace(0, nt - 1, cap, dtype=int)
    return np.arange(nt)


def _axis_res(coord: np.ndarray, cap: int = 200) -> int:
    """Resampling-grid points along one axis: the distinct-coordinate
    count (exact on tensor grids), capped so curvilinear embeddings —
    where a spanning coordinate is a product with ~N distinct values
    (spherical x = r·sinθ) — get a plot-sized grid, not an ~N×N one."""
    return int(min(max(len(np.unique(coord)), 2), cap))


def _volume_trace(Xi, Yi, Zi, value, vmin, vmax, field_name, unit,
                  opacity=0.3, surface_count=7) -> Dict[str, Any]:
    return {
        "type": "volume",
        "x": Xi.flatten(), "y": Yi.flatten(), "z": Zi.flatten(),
        "value": np.asarray(value).flatten(),
        "isomin": vmin, "isomax": vmax,
        "opacity": opacity, "surface_count": surface_count,
        "colorscale": "Viridis",
        "colorbar": {"title": f"{field_name} {unit}".strip()},
        "hovertemplate": ("x = %{x:.3f} m<br>y = %{y:.3f} m<br>z = %{z:.3f} m<br>"
                          + f"{field_name} = %{{value:.3f}} {unit}<extra></extra>"),
    }


def _plot_masked_volume(coords_arr, values_arr, times_arr, field_name, unit,
                        grid_axes, inside_mask, vmin, vmax,
                        output_dir, filename, title,
                        opacity=0.4) -> PlotResult:
    """Shared engine for the cylindrical/spherical volume plots: resample all
    frames onto a regular grid, mask points outside the geometry to a value
    below isomin (so plotly.js does not render them)."""
    Xi, Yi, Zi = np.meshgrid(*grid_axes, indexing="ij")
    query = np.column_stack([Xi.flatten(), Yi.flatten(), Zi.flatten()])
    idx = _frame_indices(len(times_arr))
    resampler = FieldResampler(coords_arr)
    vols = resampler(values_arr[idx], query)  # [nf, M]
    fill = vmin - (vmax - vmin + 1e-12) * 0.1
    vols = np.where(inside_mask.flatten()[None, :], vols, fill)

    base = _volume_trace(Xi, Yi, Zi, vols[0], vmin, vmax, field_name, unit,
                         opacity=opacity)
    names = [f"t={times_arr[i]:.3f}" for i in idx]
    frames = [{"data": [{**base, "value": vols[k]}], "name": names[k]}
              for k in range(len(idx))]
    layout = {
        "title": title,
        "scene": {
            "xaxis_title": "x (m)", "yaxis_title": "y (m)", "zaxis_title": "z (m)",
            "aspectmode": "data",
            "camera": {"eye": {"x": 1.5, "y": 1.5, "z": 1.5}},
        },
        **animation_controls(times_arr[idx], names),
    }
    path = write_figure_html([base], layout, frames, output_dir, filename, title)
    return PlotResult(html_path=path)


def _plot_cylindrical_3d(coords_arr, values_arr, times_arr, field_name, unit,
                         cylinder_radius, Lx, vmin, vmax,
                         output_dir, filename) -> PlotResult:
    """Cylinder volume rendering on a 20×15×15 grid (reference
    fenics_mcp_server.py:2939-3173)."""
    R = float(cylinder_radius)
    gx = np.linspace(0.0, Lx, 20)
    gy = np.linspace(-R, R, 15)
    gz = np.linspace(-R, R, 15)
    Xi, Yi, Zi = np.meshgrid(gx, gy, gz, indexing="ij")
    inside = np.sqrt(Yi ** 2 + Zi ** 2) <= R
    return _plot_masked_volume(
        coords_arr, values_arr, times_arr, field_name, unit,
        (gx, gy, gz), inside, vmin, vmax, output_dir, filename,
        title=f"3D cylindrical {field_name} (isosurfaces)", opacity=0.4)


def _plot_spherical_3d(coords_arr, values_arr, times_arr, field_name, unit,
                       sphere_radius, vmin, vmax,
                       output_dir, filename) -> PlotResult:
    """Sphere volume rendering on a 15³ grid (reference :3176-3406)."""
    R = float(sphere_radius)
    g = np.linspace(-R, R, 15)
    Xi, Yi, Zi = np.meshgrid(g, g, g, indexing="ij")
    inside = np.sqrt(Xi ** 2 + Yi ** 2 + Zi ** 2) <= R
    return _plot_masked_volume(
        coords_arr, values_arr, times_arr, field_name, unit,
        (g, g, g), inside, vmin, vmax, output_dir, filename,
        title=f"3D spherical {field_name} (isosurfaces)", opacity=0.4)


# ----------------------------------------------------------------------
# Generic plotter
# ----------------------------------------------------------------------

def plot_time_series_field(
    coords: List[List[float]],
    values: List[List[float]],
    times: List[float],
    dim: int = 1,
    field_name: str = "u",
    unit: str = "",
    output_dir: str = "plots",
    filename: Optional[str] = "field_timeseries_3d.html",
    domain_bounds: Optional[Dict[str, float]] = None,
    geometry_type: Optional[str] = None,
    geometry_params: Optional[Dict[str, float]] = None,
) -> PlotResult:
    """Dimension-routed animated plot (1D line / 2D surface / 3D volume)
    with the reference's cylinder/sphere routing cascade."""
    coords_arr = np.array(coords, dtype=float)
    values_arr = np.array(values, dtype=float)
    times_arr = np.array(times, dtype=float)
    if values_arr.ndim != 2:
        raise ValueError(f"'values' must have shape (Nt, N), got {values_arr.shape}")
    if coords_arr.ndim != 2 or coords_arr.shape[1] != 3:
        raise ValueError(f"'coords' must have shape (N, 3), got {coords_arr.shape}")
    if times_arr.ndim != 1 or times_arr.shape[0] != values_arr.shape[0]:
        raise ValueError(
            f"'times' must have length Nt={values_arr.shape[0]}, got {times_arr.shape}")
    Nt, Npts = values_arr.shape
    if Nt == 0 or Npts == 0:
        raise ValueError(f"Empty data: Nt={Nt}, Npts={Npts}")
    if filename is None:
        filename = "field_timeseries_3d.html"

    x, y, z = coords_arr[:, 0], coords_arr[:, 1], coords_arr[:, 2]
    vmin, vmax = float(values_arr.min()), float(values_arr.max())
    gp = geometry_params or {}

    # ----- cylinder routing cascade (reference :3475-3592) -----
    # Deliberate fix vs the reference: its lenient coordinate-based cylinder
    # detection ignores an explicit spherical geometry_type, so sphere solves
    # route to the cylindrical plotter (fenics_mcp_server.py:3524-3541 runs
    # unconditionally).  Here an explicit sphere geometry wins.
    if dim == 3:
        is_sphere_hint = geometry_type in ("sphere", "spherical_shell")
        is_cyl, R = (False, None) if is_sphere_hint else _detect_cylinder(
            coords_arr, geometry_type, gp)
        if is_cyl:
            if domain_bounds:
                Lx = domain_bounds.get("x_max") or domain_bounds.get("Lx") or float(x.max())
            elif "h" in gp:
                Lx = gp["h"]
            else:
                Lx = float(x.max())
            return _plot_cylindrical_3d(coords_arr, values_arr, times_arr,
                                        field_name, unit, R, Lx, vmin, vmax,
                                        output_dir, filename)
        if geometry_type in ("sphere", "spherical_shell"):
            R = gp.get("sphere_radius") or gp.get("r2")
            if not R or R <= 0:
                r_max = float(np.sqrt(x ** 2 + y ** 2 + z ** 2).max())
                R = r_max if r_max > 0 else 1.0
            return _plot_spherical_3d(coords_arr, values_arr, times_arr,
                                      field_name, unit, R, vmin, vmax,
                                      output_dir, filename)

    names = [f"t={t:.3f}" for t in times_arr]

    if dim == 1:
        order = np.argsort(x)
        xs = x[order]

        def line_trace(v):
            return {
                "type": "scatter", "x": xs, "y": v[order],
                "mode": "lines", "line": {"width": 3},
                "hovertemplate": ("x = %{x:.3e}<br>"
                                  + f"{field_name} = %{{y:.3f}} {unit}<extra></extra>"),
            }

        base = {**line_trace(values_arr[0]), "name": names[0]}
        frames = [{"data": [{**line_trace(values_arr[i]), "name": names[i]}],
                   "name": names[i]} for i in range(Nt)]
        layout = {
            "title": f"1D {field_name} vs x (time series)",
            "xaxis": {"title": "x (m)", "range": [float(xs.min()), float(xs.max())],
                      "showgrid": True},
            "yaxis": {"title": f"{field_name} {unit}".strip(),
                      "range": [vmin, vmax], "showgrid": True},
            **animation_controls(times_arr, names),
        }

    elif dim == 2:
        # Use the two coordinate columns that actually vary: axisymmetric
        # solves embed as (r, 0, z) / (r sinθ, 0, r cosθ) — columns 0 and 2.
        # The reference feeds columns (0, 1) to griddata unconditionally
        # (fenics_mcp_server.py:3781), which makes scipy's Delaunay throw a
        # QhullError ("initial simplex is flat") on every 2D curvilinear
        # field; picking the spanning columns fixes the whole family.
        spans = coords_arr.max(axis=0) - coords_arr.min(axis=0)
        cols = sorted(np.argsort(-spans)[:2].tolist()) \
            if np.count_nonzero(spans > 0) >= 2 else [0, 1]
        x2, y2 = coords_arr[:, cols[0]], coords_arr[:, cols[1]]
        ax_x, ax_y = ("xyz"[cols[0]], "xyz"[cols[1]])
        b = domain_bounds or {}
        x_min = b.get("x_min", float(x2.min())); x_max = b.get("x_max", float(x2.max()))
        y_min = b.get("y_min", float(y2.min())); y_max = b.get("y_max", float(y2.max()))
        # Resolution: the count of distinct coordinates reproduces tensor
        # grids exactly, but curvilinear embeddings make the spanning
        # coordinate a PRODUCT (spherical x = r·sinθ has ~N distinct
        # values) — cap the axis resolution so the interpolation grid
        # stays ~plot-sized instead of ~N×N.
        xi = np.linspace(x_min, x_max, _axis_res(x2))
        yi = np.linspace(y_min, y_max, _axis_res(y2))
        Xi, Yi = np.meshgrid(xi, yi)
        resampler = FieldResampler(np.column_stack([x2, y2]))
        grids = resampler(values_arr, np.column_stack([Xi.flatten(), Yi.flatten()]))
        grids = grids.reshape(Nt, *Xi.shape)

        def surf_trace(g):
            return {
                "type": "surface", "x": Xi, "y": Yi, "z": g, "surfacecolor": g,
                "colorscale": "Viridis", "cmin": vmin, "cmax": vmax,
                "colorbar": {"title": f"{field_name} {unit}".strip()},
                "hovertemplate": (f"{ax_x} = %{{x:.3e}}, {ax_y} = %{{y:.3e}}<br>"
                                  + f"{field_name} = %{{z:.3f}} {unit}<extra></extra>"),
            }

        base = surf_trace(grids[0])
        frames = [{"data": [surf_trace(grids[i])], "name": names[i]} for i in range(Nt)]
        # aspect policy: x/y preserve the domain shape, z fixed 0.6 visual
        # factor (reference :3839-3862)
        x_span, y_span = x_max - x_min, y_max - y_min
        spatial = max(x_span, y_span) if (x_span > 0 and y_span > 0) else 1.0
        aspect = ({"x": x_span / spatial, "y": y_span / spatial, "z": 0.6}
                  if spatial > 0 else {"x": 1, "y": 1, "z": 0.6})
        layout = {
            "title": f"2D {field_name} surface ({ax_x}, {ax_y} → space; "
                     f"z/color → value)",
            "scene": {
                "xaxis_title": f"{ax_x} (m)", "yaxis_title": f"{ax_y} (m)",
                "zaxis_title": f"{field_name} {unit}".strip(),
                "xaxis": {"range": [x_min, x_max], "showgrid": True, "autorange": False},
                "yaxis": {"range": [y_min, y_max], "showgrid": True, "autorange": False},
                "zaxis": {"range": [vmin, vmax], "showgrid": True, "autorange": False},
                "aspectmode": "manual", "aspectratio": aspect,
                "camera": {"eye": {"x": 1.5, "y": 1.5, "z": 1.2}},
            },
            **animation_controls(times_arr, names),
        }

    else:  # dim == 3 box
        xi = np.linspace(float(x.min()), float(x.max()), _axis_res(x, 40))
        yi = np.linspace(float(y.min()), float(y.max()), _axis_res(y, 40))
        zi = np.linspace(float(z.min()), float(z.max()), _axis_res(z, 40))
        Xi, Yi, Zi = np.meshgrid(xi, yi, zi, indexing="ij")
        resampler = FieldResampler(coords_arr)
        query = np.column_stack([Xi.flatten(), Yi.flatten(), Zi.flatten()])
        idx = _frame_indices(Nt)
        vols = resampler(values_arr[idx], query)
        names3 = [f"t={times_arr[i]:.3f}" for i in idx]
        base = _volume_trace(Xi, Yi, Zi, vols[0], vmin, vmax, field_name, unit)
        frames = [{"data": [{**base, "value": vols[k]}], "name": names3[k]}
                  for k in range(len(idx))]
        scene: Dict[str, Any] = {
            "xaxis_title": "x (m)", "yaxis_title": "y (m)", "zaxis_title": "z (m)",
            "aspectmode": "data",
            "camera": {"eye": {"x": 1.5, "y": 1.5, "z": 1.5}},
        }
        if domain_bounds:
            for ax, lo, hi, arr in (("xaxis", "x_min", "x_max", x),
                                    ("yaxis", "y_min", "y_max", y),
                                    ("zaxis", "z_min", "z_max", z)):
                scene[ax] = {"range": [domain_bounds.get(lo, float(arr.min())),
                                       domain_bounds.get(hi, float(arr.max()))],
                             "showgrid": True, "autorange": False}
        layout = {"title": f"3D {field_name} volume", "scene": scene,
                  **animation_controls(times_arr[idx], names3)}

    path = write_figure_html([base], layout, frames, output_dir, filename,
                             title=str(layout.get("title", "PDE field")))
    return PlotResult(html_path=path)


def _detect_cylinder(coords_arr, geometry_type, gp):
    """Three-priority cylinder detection (reference :3475-3541)."""
    x, y, z = coords_arr[:, 0], coords_arr[:, 1], coords_arr[:, 2]
    y_min, y_max = float(y.min()), float(y.max())
    z_min, z_max = float(z.min()), float(z.max())
    y_center, z_center = (y_max + y_min) / 2, (z_max + z_min) / 2
    y_span, z_span = y_max - y_min, z_max - z_min

    gts = str(geometry_type).lower() if geometry_type else ""
    if gts == "cylinder":
        R = gp.get("cylinder_radius")
        if not R:
            r_max = float(np.sqrt(y ** 2 + z ** 2).max())
            R = r_max if r_max > 0 else max(y_span, z_span) / 2.0
        return True, float(R)
    if gp and "cylinder_radius" in gp:
        R = gp["cylinder_radius"]
        if not R:
            r_max = float(np.sqrt(y ** 2 + z ** 2).max())
            R = r_max if r_max > 0 else 0.5
        return True, float(R)
    # ultra-lenient coordinate-based detection
    y_centered = abs(y_center) < 0.5 * max(y_span, 1e-10)
    z_centered = abs(z_center) < 0.5 * max(z_span, 1e-10)
    spans_ok = max(y_span, z_span) / max(min(y_span, z_span), 1e-10) < 2.5
    if y_centered and z_centered and spans_ok and y_span > 0 and z_span > 0:
        r_max = float(np.sqrt(y ** 2 + z ** 2).max())
        if r_max > 0:
            return True, r_max
    return False, None


# ----------------------------------------------------------------------
# File-based entry (the recommended tool)
# ----------------------------------------------------------------------

def plot_time_series_field_from_file(
    data_file: str,
    field_name: Optional[str] = None,
    unit: Optional[str] = None,
    output_dir: str = "plots",
    filename: Optional[str] = None,
) -> PlotResult:
    """Load a pickled TimeSeriesField and plot it, inferring geometry from
    metadata first and coordinate statistics second (reference :2764-2937)."""
    field = load_field(data_file)
    meta = field.meta or {}
    if field_name is None:
        field_name = meta.get("name", "u")
    if unit is None:
        unit = meta.get("unit", "")
    if filename is None:
        filename = f"{meta.get('pde', 'field')}_{field.dim}d_{uuid.uuid4().hex[:8]}.html"

    coords_all = field.coords_array()
    geometry_type = meta.get("geometry_type", None)
    geometry_params: Dict[str, float] = {}

    # Metadata cylinder_radius wins outright (reference :2803-2809).
    if field.dim == 3 and meta.get("cylinder_radius") is not None:
        geometry_type = "cylinder"
        geometry_params["cylinder_radius"] = float(meta["cylinder_radius"])
    if geometry_type is None:
        geometry_type = "box"

    # Coordinate-statistics inference (reference :2816-2852).
    if field.dim == 3 and geometry_type == "box":
        xc, yc, zc = coords_all[:, 0], coords_all[:, 1], coords_all[:, 2]
        y_center = (yc.max() + yc.min()) / 2
        z_center = (zc.max() + zc.min()) / 2
        y_span = yc.max() - yc.min()
        z_span = zc.max() - zc.min()
        y_centered = abs(y_center) < 0.2 * max(y_span, 1e-10)
        z_centered = abs(z_center) < 0.2 * max(z_span, 1e-10)
        spans_similar = abs(y_span - z_span) / max(y_span, z_span, 1e-10) < 0.4
        if y_centered and z_centered and spans_similar:
            r_max = float(np.sqrt(yc ** 2 + zc ** 2).max())
            if r_max > 0:
                geometry_type = "cylinder"
                geometry_params["cylinder_radius"] = r_max
        x_center = (xc.max() + xc.min()) / 2
        if abs(x_center) < 0.1 and abs(y_center) < 0.1 and abs(z_center) < 0.1:
            r_max = float(np.sqrt(xc ** 2 + yc ** 2 + zc ** 2).max())
            if r_max > 0 and abs(y_span - z_span) / max(y_span, z_span) < 0.2:
                geometry_type = "sphere"
                geometry_params["sphere_radius"] = r_max

    # Domain bounds (reference :2854-2907).
    domain_bounds = None
    if field.dim == 2:
        Lx, Ly = meta.get("Lx"), meta.get("Ly")
        if Lx is not None and Ly is not None:
            domain_bounds = {"x_min": 0.0, "x_max": float(Lx),
                             "y_min": 0.0, "y_max": float(Ly)}
    elif field.dim == 3:
        Lx, Ly, Lz = meta.get("Lx"), meta.get("Ly"), meta.get("Lz")
        if geometry_type == "cylinder" and meta.get("cylinder_radius") is not None:
            R = float(meta["cylinder_radius"])
            if Lx is not None:
                domain_bounds = {"x_min": 0.0, "x_max": float(Lx),
                                 "y_min": -R, "y_max": R, "z_min": -R, "z_max": R}
            geometry_params["cylinder_radius"] = R
        elif geometry_type in ("sphere", "spherical_shell"):
            R = meta.get("r_outer") or meta.get("sphere_radius") or 1.0
            R = float(R)
            domain_bounds = {"x_min": -R, "x_max": R, "y_min": -R, "y_max": R,
                             "z_min": -R, "z_max": R}
            geometry_params["sphere_radius"] = R
        elif Lx is not None and Ly is not None and Lz is not None:
            domain_bounds = {"x_min": 0.0, "x_max": float(Lx),
                             "y_min": 0.0, "y_max": float(Ly),
                             "z_min": 0.0, "z_max": float(Lz)}
    elif field.dim == 1:
        length = meta.get("length")
        if length is not None:
            domain_bounds = {"x_min": 0.0, "x_max": float(length)}

    if geometry_type == "cylinder" and "cylinder_radius" not in geometry_params \
            and meta.get("cylinder_radius") is not None:
        geometry_params["cylinder_radius"] = float(meta["cylinder_radius"])
    if geometry_type in ("sphere", "spherical_shell") \
            and "sphere_radius" not in geometry_params:
        R = meta.get("r_outer") or meta.get("sphere_radius")
        if R is not None:
            geometry_params["sphere_radius"] = float(R)

    return plot_time_series_field(
        coords=field.coords_array(), values=field.values_array(),
        times=field.times_array(), dim=field.dim,
        field_name=field_name, unit=unit,
        output_dir=output_dir, filename=filename,
        domain_bounds=domain_bounds, geometry_type=geometry_type,
        geometry_params=geometry_params,
    )
