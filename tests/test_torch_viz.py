"""The port's plot tools (``pde_solver_tpu_torch.viz``) against the JAX
package's: the cases of ``tests/test_viz.py`` run through the port, and for
the same field pickle (written by either package) both packages write the
same HTML, byte for byte, under the same filename.

The port's solves run on the CPU in its "mixed" policy (float32 transients);
the plots are host numpy/scipy in both packages."""

import inspect
import json
import re

import numpy as np
import pytest

from pde_solver_tpu import api as ref_api
from pde_solver_tpu.fields import TimeSeriesField as RefField
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu_torch import api, config
from pde_solver_tpu_torch.fields import TimeSeriesField, load_field
from pde_solver_tpu_torch.viz.plots import (plot_time_series_field,
                                            plot_time_series_field_from_file)
from pde_solver_tpu_torch.viz.resample import (FieldResampler,
                                               detect_structured_grid)

CPU = dict(device="cpu", precision="mixed")


def _port(tool, tmp_path, **kw):
    with config.config_overrides(**CPU):
        return getattr(api, tool)(**kw, data_dir=str(tmp_path))


def _read_fig(html_path):
    with open(html_path) as f:
        html = f.read()
    assert "Plotly.newPlot" in html
    assert "cdn.plot.ly" in html
    m = re.search(r"var fig = (\{.*?\});\nvar config", html, re.S)
    assert m, "figure JSON not found in HTML"
    return json.loads(m.group(1)), html


def _plot_file(res, tmp_path):
    return plot_time_series_field_from_file(
        res.data_file, output_dir=str(tmp_path / "plots"))


# ----------------------------------------------------------------------
# the cases of tests/test_viz.py, through the port
# ----------------------------------------------------------------------

def test_detect_structured_grid():
    x, y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 2, 4), indexing="ij")
    pts = np.column_stack([x.flatten(), y.flatten()])
    rng = np.random.default_rng(0)
    res = detect_structured_grid(pts[rng.permutation(len(pts))])
    assert res is not None
    assert detect_structured_grid(rng.standard_normal((20, 2))) is None


def test_resampler_structured_exact_on_linear_field():
    x, y = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 7), indexing="ij")
    pts = np.column_stack([x.flatten(), y.flatten()])
    vals = (2 * pts[:, 0] + 3 * pts[:, 1])[None, :]
    q = np.array([[0.25, 0.5], [0.111, 0.9], [0.77, 0.33]])
    out = FieldResampler(pts)(vals, q)
    assert np.allclose(out[0], 2 * q[:, 0] + 3 * q[:, 1], atol=1e-12)


def test_resampler_scattered_matches_griddata():
    from scipy.interpolate import griddata
    rng = np.random.default_rng(1)
    pts = rng.random((60, 2))
    vals = np.sin(pts[:, 0] * 3) + pts[:, 1] ** 2
    q = rng.random((25, 2)) * 0.8 + 0.1
    mine = FieldResampler(pts)(vals, q)
    gold = griddata(pts, vals, q, method="linear")
    ok = ~np.isnan(gold)
    assert np.allclose(mine[ok], gold[ok], atol=1e-10)


def test_plot_1d_line_html(tmp_path):
    res = _port("solve_heat_1D", tmp_path, nx=12, num_steps=3)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert fig["data"][0]["type"] == "scatter"
    assert len(fig["frames"]) == 4
    assert fig["layout"]["sliders"][0]["steps"][0]["label"] == "0.000"
    assert fig["layout"]["xaxis"]["range"] == [0.0, 2.0]


def test_plot_2d_surface_html(tmp_path):
    res = _port("solve_heat_2D", tmp_path, nx=6, ny=5, num_steps=2)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert fig["data"][0]["type"] == "surface"
    assert len(fig["frames"]) == 3
    assert fig["layout"]["scene"]["aspectratio"] == {"x": 1.0, "y": 1.0,
                                                     "z": 0.6}


def test_plot_3d_box_volume_html(tmp_path):
    res = _port("solve_heat_3D", tmp_path, nx=4, ny=4, nz=4, num_steps=2)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert fig["data"][0]["type"] == "volume"
    assert fig["layout"]["scene"]["aspectmode"] == "data"


def test_plot_3d_cylinder_routing(tmp_path):
    res = _port("solve_heat_3D", tmp_path, nx=5, ny=6, nz=6, num_steps=2,
                geometry_type="cylinder", cylinder_radius=0.5, T_left=80.0,
                T_right=10.0)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert fig["data"][0]["type"] == "volume"
    assert len(fig["data"][0]["x"]) == 20 * 15 * 15
    assert "cylindrical" in fig["layout"]["title"]


def test_plot_3d_sphere_routing(tmp_path):
    res = _port("solve_heat_3D_spherical", tmp_path, nr=5, ntheta=5, nphi=6,
                num_steps=2)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert fig["data"][0]["type"] == "volume"
    assert len(fig["data"][0]["x"]) == 15 ** 3
    assert "spherical" in fig["layout"]["title"]


def test_plot_frame_cap_30_for_3d(tmp_path):
    res = _port("solve_heat_3D", tmp_path, nx=3, ny=3, nz=3, num_steps=40)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert len(fig["frames"]) == 30


def test_plot_raw_arrays_validation():
    with pytest.raises(ValueError):
        plot_time_series_field(coords=[[0, 0, 0]], values=[[1.0], [2.0]],
                               times=[0.0], dim=1)
    with pytest.raises(ValueError):
        plot_time_series_field(coords=[[0, 0]], values=[[1.0]], times=[0.0],
                               dim=1)


def test_plot_elasticity_field_names(tmp_path):
    res = _port("solve_elasticity_2D_static", tmp_path, nx=5, ny=5,
                body_fy=-1e4)
    fig, _ = _read_fig(_plot_file(res, tmp_path).html_path)
    assert "von_mises_stress" in fig["layout"]["title"]


def test_axisymmetric_2d_fields_plot_without_qhull_error(tmp_path):
    r = _port("solve_heat_2D_cylindrical", tmp_path, r_inner=0.05,
              r_outer=0.07, z_length=0.07, nr=8, nz=8, steady=True,
              T_boundary=20.0)
    html = open(api.plot_time_series_field_from_file(
        r.data_file, output_dir=str(tmp_path)).html_path).read()
    assert "Plotly.newPlot" in html
    assert '"xaxis_title": "x (m)"' in html and '"yaxis_title": "z (m)"' in html
    r2 = _port("solve_heat_2D_spherical", tmp_path, nr=8, ntheta=8,
               steady=True)
    p2 = api.plot_time_series_field_from_file(r2.data_file,
                                              output_dir=str(tmp_path))
    assert "Plotly.newPlot" in open(p2.html_path).read()


# ----------------------------------------------------------------------
# the same pickle → the same HTML in both packages
# ----------------------------------------------------------------------

FIELDS = {
    "1d": ("solve_heat_1D", dict(nx=12, num_steps=3)),
    "2d": ("solve_heat_2D", dict(nx=6, ny=5, num_steps=2)),
    "3d_box": ("solve_heat_3D", dict(nx=4, ny=4, nz=4, num_steps=2)),
    "cylinder": ("solve_heat_3D", dict(nx=5, ny=6, nz=6, num_steps=2,
                                       geometry_type="cylinder",
                                       cylinder_radius=0.5, T_left=80.0,
                                       T_right=10.0)),
    "sphere": ("solve_heat_3D_spherical", dict(nr=5, ntheta=5, nphi=6,
                                               num_steps=2)),
}


def _pickle(writer, kind, tmp_path):
    tool, kw = FIELDS[kind]
    if writer == "jax":
        return getattr(ref_api, tool)(**kw, data_dir=str(tmp_path)).data_file
    return _port(tool, tmp_path, **kw).data_file


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_same_pickle_same_html(kind, writer, tmp_path):
    data_file = _pickle(writer, kind, tmp_path)
    name = f"{kind}.html"
    port = api.plot_time_series_field_from_file(
        data_file, output_dir=str(tmp_path / "port"), filename=name)
    ref = ref_api.plot_time_series_field_from_file(
        data_file, output_dir=str(tmp_path / "ref"), filename=name)
    with open(port.html_path, "rb") as f, open(ref.html_path, "rb") as g:
        html, html_ref = f.read(), g.read()
    assert b"Plotly.newPlot" in html
    assert html == html_ref


@pytest.mark.parametrize("dim,geometry", [(1, None), (2, None), (3, None),
                                          (3, "cylinder"), (3, "sphere")])
def test_raw_arrays_same_html(dim, geometry, tmp_path):
    """``plot_time_series_field`` on the same arrays: the same HTML."""
    rng = np.random.default_rng(dim)
    axes = [np.linspace(-0.5, 0.5, n) for n in (7, 5, 4)[:dim]]
    grid = np.meshgrid(*axes, indexing="ij")
    coords = np.zeros((grid[0].size, 3))
    for i, g in enumerate(grid):
        coords[:, i] = g.ravel()
    values = rng.standard_normal((3, len(coords)))
    kw = dict(coords=coords.tolist(), values=values.tolist(),
              times=[0.0, 0.1, 0.2], dim=dim, field_name="T", unit="°C",
              filename="raw.html", geometry_type=geometry)
    port = api.plot_time_series_field(**kw, output_dir=str(tmp_path / "p"))
    ref = ref_api.plot_time_series_field(**kw, output_dir=str(tmp_path / "r"))
    with open(port.html_path, "rb") as f, open(ref.html_path, "rb") as g:
        assert f.read() == g.read()


def test_port_loads_and_plots_a_jax_pickle(tmp_path):
    data_file = _pickle("jax", "2d", tmp_path)
    field, ref = load_field(data_file), ref_load(data_file)
    assert isinstance(field, TimeSeriesField) and isinstance(ref, RefField)
    assert np.array_equal(field.values_array(), ref.values_array())
    assert np.array_equal(field.coords_array(), ref.coords_array())
    assert field.meta == ref.meta
    fig, _ = _read_fig(plot_time_series_field_from_file(
        data_file, output_dir=str(tmp_path / "plots")).html_path)
    assert fig["data"][0]["type"] == "surface"



@pytest.mark.parametrize("tool", ["plot_time_series_field_from_file",
                                  "plot_time_series_field"])
def test_plot_tool_signature_matches_reference(tool):
    assert inspect.signature(getattr(api, tool)) == \
        inspect.signature(getattr(ref_api, tool))
