"""The plain reference against the port, on the CPU at tiny sizes (the
port runs float64 there), and the reference's own pieces."""

import numpy as np
import pytest
import torch

from portbench.drivers.elasticity3d import body_force
from portbench.reference import elasticity_static, heat_theta, p1


def test_prolong_restrict_are_transposes():
    g = torch.Generator().manual_seed(0)
    xc = torch.rand((3, 5, 3, 4), generator=g, dtype=torch.float64)
    xf = torch.rand((3, 9, 5, 7), generator=g, dtype=torch.float64)
    lhs = torch.sum(p1.prolong(xc, (9, 5, 7)) * xf)
    rhs = torch.sum(xc * p1.restrict(xf, (5, 3, 4)))
    assert abs(float(lhs - rhs)) < 1e-12 * float(abs(lhs))


def test_prolong_keeps_linear_fields():
    """P1 interpolation between nested meshes reproduces a linear field."""
    fine, coarse = p1.Grid((8, 4, 6), (1.0, 0.5, 0.7)), \
        p1.Grid((4, 2, 3), (1.0, 0.5, 0.7))

    def lin(g):
        ax = [torch.arange(n, dtype=torch.float64) * h
              for n, h in zip(g.nodes, g.spacing)]
        X, Y, Z = torch.meshgrid(*ax, indexing="ij")
        return (1.0 + 2.0 * X - 3.0 * Y + 0.5 * Z)[None]

    assert torch.allclose(p1.prolong(lin(coarse), fine.nodes), lin(fine),
                          atol=1e-13)


def test_operator_row_sums():
    """Mass rows sum to ∫φ; stiffness rows sum to zero."""
    grid = p1.Grid((4, 3, 5), (1.0, 0.6, 1.2))
    one = torch.ones((1,) + grid.nodes, dtype=torch.float64)
    M = p1.StencilOperator(grid, p1.mass_matrices(grid.spacing),
                           torch.float64, "cpu")
    K = p1.StencilOperator(grid, p1.stiffness_matrices(grid.spacing),
                           torch.float64, "cpu")
    vol = elasticity_static.nodal_volume(grid, torch.float64, "cpu")
    assert torch.allclose(M(one)[0], vol, rtol=1e-13)
    assert float(K(one).abs().max()) < 1e-12
    assert abs(float(vol.sum()) - 1.0 * 0.6 * 1.2) < 1e-13


@pytest.mark.parametrize("req", [
    dict(T_left=30.0, T_right=70.0, T_side=10.0, T_initial=25.0),
    dict(T_left=0.0, T_right=100.0, T_side=55.0, T_initial=5.0,
         diffusivity=0.25),
])
def test_heat_reference_matches_port(req, tmp_path):
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.fields import load_field

    cfg = {"mesh": {"cells": [8, 6, 7], "extent": [1.0, 0.8, 0.9]},
           "tool_args": {"dt": 0.01, "num_steps": 9, "diffusivity": 1.0},
           "config_overrides": {"snapshot_max_frames": 4}}
    ref = heat_theta.trajectory(cfg, req, "cpu", tol=1e-12)
    with config_overrides(device="cpu", snapshot_max_frames=4):
        res = api.solve_heat_3D(Lx=1.0, Ly=0.8, Lz=0.9, nx=8, ny=6, nz=7,
                                dt=0.01, num_steps=9,
                                data_dir=str(tmp_path), **req)
    f = load_field(res.data_file)
    np.testing.assert_array_equal(np.asarray(f.times), ref["times"])
    gap = np.abs(np.asarray(f.values) - ref["values"]).max()
    assert gap <= 1e-8 * np.abs(ref["values"]).max()


def test_frame_steps_follow_the_cap():
    assert heat_theta.frame_steps(200, 10) == list(range(20, 201, 20))
    assert heat_theta.frame_steps(9, 4) == [3, 6, 9]
    assert heat_theta.frame_steps(10, 4) == [3, 6, 9, 10]
    assert heat_theta.frame_steps(5, 0) == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("load", [(1.0, 0.0, 0.0), (2.5, 30.0, 200.0)])
def test_cantilever_reference_matches_port(load, tmp_path):
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.fields import load_field

    cfg = {"mesh": {"cells": [16, 4, 4], "extent": [1.0, 0.2, 0.2]},
           "tool_args": {"E": 210e9, "nu": 0.3}, "density": 7850.0,
           "gravity": 9.81}
    req = dict(zip(("load_factor", "tilt_deg", "azimuth_deg"), load))
    fx, fy, fz = body_force(cfg, req)
    vm_ref = elasticity_static.Cantilever(cfg, "cpu").von_mises((fx, fy, fz))
    with config_overrides(device="cpu"):
        res = api.solve_elasticity_3D_static(
            Lx=1.0, Ly=0.2, Lz=0.2, nx=16, ny=4, nz=4, body_fx=fx,
            body_fy=fy, body_fz=fz, data_dir=str(tmp_path))
    vm = np.asarray(load_field(res.data_file).values)[0]
    assert np.abs(vm - vm_ref).max() <= 1e-9 * np.abs(vm_ref).max()


def test_lower_precision_reference_reads_further_off():
    """The heat control (the reference in bfloat16, to the same stopping
    rule) solves every step, and lies further from the float64 reference
    than float64 rounding, yet nearer than a state left unchanged, at a
    tiny size."""
    steps = 6
    cfg = {"mesh": {"cells": [8, 8, 8], "extent": [1.0, 1.0, 1.0]},
           "tool_args": {"dt": 0.01, "num_steps": steps, "diffusivity": 1.0},
           "config_overrides": {"snapshot_max_frames": 3}}
    req = dict(T_left=20.0, T_right=90.0, T_side=40.0, T_initial=10.0)
    ref = heat_theta.trajectory(cfg, req, "cpu", tol=1e-12)
    low = heat_theta.trajectory(cfg, req, "cpu", dtype=torch.bfloat16)
    scale = np.abs(ref["values"]).max()
    gap = np.abs(low["values"] - ref["values"]).max() / scale
    frozen = np.abs(ref["values"][0] - ref["values"]).max() / scale
    assert low["iterations"] >= steps
    assert 1e-4 < gap < 0.5 * frozen
