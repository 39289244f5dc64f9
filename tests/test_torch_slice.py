"""The ported slice end to end: the flagship's tool, 3D static elasticity of
a gravity-loaded cantilever, through both packages at a small size."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu_torch import api
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.fields import load_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=16, ny=8, nz=8, E=210e9, nu=0.3,
                body_fz=-9.81 * 7800)
# host_direct_threshold=0 and mg_threshold=100 so that this small mesh goes
# through MG and the F-cycle, as the flagship does, and not sparse LU
SLICE = dict(precision="mixed", host_direct_threshold=0, mg_threshold=100)


def test_signature_matches_reference():
    assert inspect.signature(api.solve_elasticity_3D_static) == \
        inspect.signature(ref_api.solve_elasticity_3D_static)


def test_flagship_slice_matches_reference(tmp_path):
    with ref_config.config_overrides(**SLICE):
        r_ref = ref_api.solve_elasticity_3D_static(
            **FLAGSHIP, data_dir=str(tmp_path / "ref"))
    with config.config_overrides(device="cpu", **SLICE):
        r = api.solve_elasticity_3D_static(
            **FLAGSHIP, data_dir=str(tmp_path / "port"))
    f_ref, f = ref_load(r_ref.data_file), load_field(r.data_file)
    s_ref, s = r_ref.meta["solver_stats"], r.meta["solver_stats"]
    assert s_ref["converged"] and s["converged"], (s_ref, s)
    assert s["num_dofs"] == s_ref["num_dofs"] == 17 * 9 * 9 * 3
    assert set(r.meta) == set(r_ref.meta)
    assert {k: v for k, v in r.meta.items() if k != "solver_stats"} == \
        {k: v for k, v in r_ref.meta.items() if k != "solver_stats"}
    assert np.array_equal(f.coords_array(), f_ref.coords_array())
    vm, vm_ref = f.values_array(), f_ref.values_array()
    assert vm.shape == vm_ref.shape == (1, 17 * 9 * 9)
    assert np.all(np.isfinite(vm))
    assert np.abs(vm - vm_ref).max() <= 1e-6 * np.abs(vm_ref).max()


def test_below_kernel_threshold_levels_take_the_grid_route(tmp_path,
                                                           monkeypatch):
    """Levels under KERNEL_MIN_DOF apply through plain shifted slices in grid
    layout (f32 smoothing, no flat state): same answer as the kernel route."""
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    with config.config_overrides(device="cpu", **SLICE):
        r_flat = api.solve_elasticity_3D_static(
            **FLAGSHIP, data_dir=str(tmp_path / "flat"))
        monkeypatch.setattr(sk, "KERNEL_MIN_DOF", 10 ** 9)
        r_grid = api.solve_elasticity_3D_static(
            **FLAGSHIP, data_dir=str(tmp_path / "grid"))
    assert r_flat.meta["solver_stats"]["converged"]
    assert r_grid.meta["solver_stats"]["converged"]
    vm_f = load_field(r_flat.data_file).values_array()
    vm_g = load_field(r_grid.data_file).values_array()
    assert np.abs(vm_g - vm_f).max() <= 1e-6 * np.abs(vm_f).max()


def test_config_device_drives_precision_and_unported_paths_raise(tmp_path):
    assert config.SolverConfig().device == "cuda"
    assert config.SolverConfig().resolve_precision() == "mixed"
    assert config.SolverConfig(device="cpu").resolve_precision() == "f64"
    with config.config_overrides(device="cpu", precision="f64"):
        with pytest.raises(NotImplementedError):
            api.solve_elasticity_3D_static(**FLAGSHIP,
                                           data_dir=str(tmp_path))
    with config.config_overrides(device="cpu", shard_devices=4):
        with pytest.raises(NotImplementedError):
            api.solve_elasticity_3D_static(**FLAGSHIP,
                                           data_dir=str(tmp_path))


def test_host_direct_branch_matches_reference(tmp_path):
    # default host_direct_threshold: this mesh is solved by sparse LU
    small = dict(FLAGSHIP, nx=8, ny=4, nz=4)
    r_ref = ref_api.solve_elasticity_3D_static(**small,
                                               data_dir=str(tmp_path))
    with config.config_overrides(device="cpu"):
        r = api.solve_elasticity_3D_static(**small, data_dir=str(tmp_path))
    assert r.meta["solver_stats"]["converged"]
    vm, vm_ref = (load_field(r.data_file).values_array(),
                  ref_load(r_ref.data_file).values_array())
    assert np.abs(vm - vm_ref).max() <= 1e-9 * np.abs(vm_ref).max()


def test_port_never_imports_jax():
    code = ("import sys, pde_solver_tpu_torch.api, pde_solver_tpu_torch.convert,"
            " pde_solver_tpu_torch.ops.timestepping,"
            " pde_solver_tpu_torch.ops.cs_kernels,"
            " pde_solver_tpu_torch.ops.surface,"
            " pde_solver_tpu_torch.models.heat,"
            " pde_solver_tpu_torch.models.advection,"
            " pde_solver_tpu_torch.models.wave,"
            " pde_solver_tpu_torch.ops.floor_probes,"
            " pde_solver_tpu_torch.ops.eigen;"
            "from pde_solver_tpu_torch.api import (solve_heat_3D,"
            " solve_heat_1D, solve_heat_2D, solve_heat_1D_cylindrical,"
            " solve_heat_1D_spherical, solve_heat_2D_cylindrical,"
            " solve_heat_2D_spherical, solve_heat_3D_spherical,"
            " solve_elasticity_1D_static, solve_elasticity_2D_static,"
            " solve_elasticity_1D_loaded, solve_elasticity_2D_loaded,"
            " solve_elasticity_3D_loaded, solve_heat_1D_mixed,"
            " solve_heat_2D_mixed, solve_heat_3D_mixed,"
            " solve_heat_radial_mixed, solve_heat_1D_nonlinear,"
            " solve_heat_2D_nonlinear, solve_advection_1D,"
            " solve_advection_2D, solve_advection_3D,"
            " solve_wave_1D, solve_wave_2D, solve_wave_3D,"
            " solve_elasticity_3D_dynamic, solve_elasticity_2D_modal,"
            " solve_elasticity_3D_modal);"
            "pde_solver_tpu_torch.ops.timestepping.run_newmark;"
            "pde_solver_tpu_torch.ops.eigen.smallest_modes;"
            "pde_solver_tpu_torch.ops.floor_probes.kernel_floor;"
            "pde_solver_tpu_torch.models.heat.solve_heat_nonlinear;"
            "pde_solver_tpu_torch.models.advection.solve_advection_problem;"
            "assert 'jax' not in sys.modules, 'jax imported';"
            "assert not any(m.startswith('pde_solver_tpu.') or "
            "m == 'pde_solver_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
