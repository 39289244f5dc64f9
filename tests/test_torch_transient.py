"""The transient heat slice of the port against the JAX package:
``solve_heat_3D`` through its plain-CG, multigrid and constant-interior
routes at small sizes, the steady tool, snapshot thinning, what is not
ported yet (and what since was), and ``mg_pcg``'s ``resync_every``."""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu.mesh import box_mesh as ref_box
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops import pallas_kernels
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu.ops.linsolve import prepare_system as ref_prepare
from pde_solver_tpu.ops.timestepping import _combine as ref_combine
from pde_solver_tpu_torch import api
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.models import heat
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from torch_stats import same_keys


def _run(tmp_path, ref_cfg, port_cfg, **tool):
    """solve_heat_3D through both packages; returns (port, reference) as
    (values, times, meta)."""
    with ref_config.config_overrides(**ref_cfg):
        r_ref = ref_api.solve_heat_3D(**tool, data_dir=str(tmp_path / "ref"))
    with config.config_overrides(device="cpu", **port_cfg):
        r = api.solve_heat_3D(**tool, data_dir=str(tmp_path / "port"))
    f, f_ref = load_field(r.data_file), ref_load(r_ref.data_file)
    assert np.array_equal(f.coords_array(), f_ref.coords_array())
    return ((f.values_array(), f.times_array(), r.meta),
            (f_ref.values_array(), f_ref.times_array(), r_ref.meta))


def _assert_same_meta(meta, meta_ref):
    assert {k: v for k, v in meta.items() if k != "solver_stats"} == \
        {k: v for k, v in meta_ref.items() if k != "solver_stats"}
    assert same_keys(meta["solver_stats"], meta_ref["solver_stats"])


def _gap(v, v_ref):
    return np.abs(v - v_ref).max() / np.abs(v_ref).max()


def test_signature_matches_reference():
    assert inspect.signature(api.solve_heat_3D) == \
        inspect.signature(ref_api.solve_heat_3D)


def test_plain_cg_route_matches_reference(tmp_path):
    cfg = dict(precision="f32", transient_inner_tol=1e-8)
    (v, t, meta), (v_ref, t_ref, meta_ref) = _run(
        tmp_path, cfg, cfg, nx=12, ny=12, nz=12, num_steps=4)
    assert v.shape == v_ref.shape == (5, 13 ** 3)
    assert np.array_equal(t, t_ref)
    _assert_same_meta(meta, meta_ref)
    assert meta["solver_stats"]["converged"]
    assert _gap(v, v_ref) <= 1e-6


def test_mg_route_matches_reference(tmp_path, monkeypatch):
    """16³ with the MG thresholds lowered: every step solves by MG-PCG
    (without periodic resyncs: the step program's MG-PCG, and any
    per-step rerun's, is built with ``resync_every`` 0), in float32 on
    both sides ("mixed" maps to f32 inside the scan, as in the
    reference).

    Δt = 0.002: at Δt = 0.01 each package's float32 trajectory lies about
    1e-6·max|T| from the float64 one (the f32 state and weights, amplified
    by the step operator's condition number), so the two differ by ~10
    float32 ulps of max|T| — rounding noise at the bound.  A smaller Δt
    lowers the condition number and leaves the MG route otherwise the
    same."""
    calls = []
    orig = mg._pcg_program

    def spy(h, resync_every):
        calls.append(resync_every)
        return orig(h, resync_every)

    monkeypatch.setattr(mg, "_pcg_program", spy)
    cfg = dict(precision="mixed", transient_mg_threshold=100,
               mg_threshold=100, transient_inner_tol=1e-8)
    (v, t, meta), (v_ref, t_ref, meta_ref) = _run(
        tmp_path, cfg, cfg, nx=16, ny=16, nz=16, num_steps=3, dt=0.002)
    assert calls and set(calls) == {0}
    assert abs(meta["solver_stats"]["cg_iterations"]
               - meta_ref["solver_stats"]["cg_iterations"]) <= 1
    assert np.array_equal(t, t_ref)
    _assert_same_meta(meta, meta_ref)
    assert meta["solver_stats"]["converged"]
    assert _gap(v, v_ref) <= 1e-6


def test_cs_route_matches_reference_and_dense(tmp_path, monkeypatch):
    """PDE_TPU_CS=1 on both sides: the per-step CG operator is the
    constant-interior one (Pallas interpret on the JAX side)."""
    built = []
    orig = ck.CSFlatStencilOperator.try_build.__func__

    def spy(cls, *a, **kw):
        op = orig(cls, *a, **kw)
        built.append(op)
        return op

    monkeypatch.setattr(ck.CSFlatStencilOperator, "try_build",
                        classmethod(spy))
    monkeypatch.setenv("PDE_TPU_PALLAS", "1")
    monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_DOF", 100)
    monkeypatch.setattr(ck, "CS_MIN_DOF", 100)   # both size gates lowered
    monkeypatch.setenv("PDE_TPU_CS", "1")
    cfg = dict(precision="f32", transient_inner_tol=1e-8)
    tool = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=40, ny=6, nz=6, num_steps=4)
    (v_cs, t, meta), (v_ref, t_ref, _) = _run(tmp_path / "cs", cfg, cfg,
                                               **tool)
    assert len(built) == 1 and built[0] is not None
    assert np.array_equal(t, t_ref)
    assert meta["solver_stats"]["converged"]
    assert _gap(v_cs, v_ref) <= 1e-5
    monkeypatch.setenv("PDE_TPU_CS", "0")
    with config.config_overrides(device="cpu", **cfg):
        r = api.solve_heat_3D(**tool, data_dir=str(tmp_path / "dense"))
    assert len(built) == 1
    assert _gap(v_cs, load_field(r.data_file).values_array()) <= 1e-5


@pytest.mark.parametrize("bcs", [
    dict(T_boundary=5.0, source_type="constant", source_value=3.0),
    dict(T_left=100.0, T_right=0.0, T_side=20.0),
    dict(T_left=100.0, core_radius=0.3, core_diffusivity=10.0),
    dict(geometry_type="cylinder", cylinder_radius=0.5, T_left=50.0,
         T_side=10.0),
])
def test_steady_matches_reference(tmp_path, bcs):
    (v, t, meta), (v_ref, t_ref, meta_ref) = _run(
        tmp_path, {}, {}, nx=8, ny=6, nz=6, steady=True, **bcs)
    assert v.shape == v_ref.shape and v.shape[0] == 1
    _assert_same_meta(meta, meta_ref)
    assert meta["solver_stats"]["converged"]
    assert _gap(v, v_ref) <= 1e-6


def test_cosine_initial_field_matches_reference(tmp_path):
    cfg = dict(precision="f32", transient_inner_tol=1e-8)
    (v, t, _), (v_ref, t_ref, _) = _run(
        tmp_path, cfg, cfg, nx=8, ny=6, nz=6, num_steps=2,
        initial_type="cosine", initial_amplitude=3.0, initial_wavenumber=2.0)
    assert np.abs(v[0] - v_ref[0]).max() <= 1e-9 * np.abs(v_ref[0]).max()
    assert _gap(v, v_ref) <= 1e-6


def test_snapshot_thinning_keeps_the_reference_frames(tmp_path):
    cfg = dict(precision="f32", transient_inner_tol=1e-8,
               snapshot_max_frames=2)
    (v, t, _), (v_ref, t_ref, _) = _run(tmp_path, cfg, cfg, nx=8, ny=6,
                                        nz=6, num_steps=5)
    assert v.shape == v_ref.shape == (3, 9 * 7 * 7)
    assert np.array_equal(t, t_ref)
    assert _gap(v, v_ref) <= 1e-6


def _small_heat():
    mesh = box_mesh(6, 4, 4, (0, 0, 0), (1, 1, 1))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    u0 = np.full(mesh.node_shape, 20.0)
    return K, M, mesh, bc, np.zeros(mesh.node_shape), u0


@pytest.mark.parametrize("what", ["time_mod", "C_np", "checkpoint", "shard",
                                  "f64", "robin", "mod_omega"])
def test_unported_inputs_raise(what, tmp_path, monkeypatch):
    """Periodic driving, explicit convection and Robin faces, which raised
    until they were ported, run and change the answer; so do checkpointing
    (bitwise the uncheckpointed scan), float64 scans (held to the JAX
    package's float64 scan at 1e-9) and sharded scans (4 virtual shards at
    float64: within 1e-9 of the unsharded port and of the JAX package's
    sharded scan, with the same iterations)."""
    K, M, mesh, bc, b, u0 = _small_heat()
    kw, cfg = {}, dict(device="cpu", precision="f32")
    if what == "checkpoint":
        with config.config_overrides(**cfg):
            v0 = timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01,
                                            4).values
        with config.config_overrides(transient_checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path), **cfg):
            v = timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01,
                                           4).values
        assert np.array_equal(v, v0) and not os.listdir(tmp_path)
        return
    if what == "f64":
        rmesh = ref_box(6, 4, 4, (0, 0, 0), (1, 1, 1))
        v_ref = ref_ts.run_transient(
            ref_asm.assemble_scalar_stencil(rmesh, "stiffness"),
            ref_asm.assemble_scalar_stencil(rmesh, "mass"), rmesh,
            RefBC(bc.free_mask, bc.values), b, u0, 0.01, 2).values
        with config.config_overrides(device="cpu", precision="f64"):
            v = timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01,
                                           2).values
        assert v.shape == v_ref.shape
        assert np.abs(v - v_ref).max() <= 1e-9 * np.abs(v_ref).max()
        return
    if what == "time_mod":
        kw["time_mod"] = {"omega": 1.0, "source_amp": b + 1.0}
    elif what == "C_np":
        kw["C_np"] = assembly.assemble_convection_stencil(
            mesh, np.array([1.0, 0.0, 0.0]))
    if what == "shard":
        monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "4")
        rmesh = ref_box(6, 4, 4, (0, 0, 0), (1, 1, 1))
        with ref_config.config_overrides(precision="f64", shard_devices=4):
            r_ref = ref_ts.run_transient(
                ref_asm.assemble_scalar_stencil(rmesh, "stiffness"),
                ref_asm.assemble_scalar_stencil(rmesh, "mass"), rmesh,
                RefBC(bc.free_mask, bc.values), b, u0, 0.01, 2)
        runs = []
        for n in (4, 0):
            with config.config_overrides(device="cpu", precision="f64",
                                         shard_devices=n):
                runs.append(timestepping.run_transient(K, M, mesh, bc, b, u0,
                                                       0.01, 2))
        sh, plain = runs
        for ref in (plain, r_ref):
            assert sh.values.shape == ref.values.shape
            assert _gap(sh.values, ref.values) <= 1e-9
            assert sh.total_cg_iterations == ref.total_cg_iterations
        return
    with config.config_overrides(**cfg):
        if what == "robin":
            plain = dict(mesh=mesh, bc_pairs=[(mesh.face_mask(0, 0), 1.0)],
                         num_steps=2)
            extra = dict(robin_faces=[(0, 1, 5.0, 0.0)])
        elif what == "mod_omega":
            plain = dict(mesh=mesh, bc_pairs=[(all_boundary(mesh), 0.0)],
                         T_initial=20.0, num_steps=2)
            extra = dict(source_amp=1.0, mod_omega=1.0)
        if what in ("robin", "mod_omega"):
            _, v0, _ = heat.solve_heat_problem(heat.HeatProblem(**plain))
            _, v, info = heat.solve_heat_problem(
                heat.HeatProblem(**plain, **extra))
            assert info["converged"]
        else:
            v0 = timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01,
                                            2).values
            v = timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01, 2,
                                           **kw).values
    assert v.shape == v0.shape and np.all(np.isfinite(v))
    assert np.abs(v - v0).max() > 1e-6 * np.abs(v0).max()


def test_mg_pcg_without_resync_matches_reference():
    """``resync_every=0`` (the transient step's setting), against resyncs
    every 2 and 3 iterations (the solve takes 4, so the resync branch runs)
    and the default 16, on a hierarchy carried over from the JAX package:
    same iterations, same answer."""
    mesh = ref_box(8, 8, 8, (0, 0, 0), (1, 1, 1))

    def builder(mc):
        K = ref_asm.assemble_scalar_stencil(mc, "stiffness")
        M = ref_asm.assemble_scalar_stencil(mc, "mass")
        return (ref_combine(K, M, 0.01, 1.0),
                RefBC.from_masks([(mc.boundary_mask(), 0.0)], mc.node_shape))

    A, bc = builder(mesh)
    b = ref_asm.assemble_load(mesh)
    sysm = ref_prepare(A, mesh, bc, b, 1)
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=1,
                                   dtype=jnp.float32)
    h = convert.hierarchy_from_numpy(
        [dict(offsets=lv.offsets, weights=lv.host_weights,
              free=np.asarray(lv.free), omega=lv.omega, s=lv.host_scale[0],
              host_Ainv=lv.host_Ainv) for lv in h_ref.levels],
        h_ref.grid_dim, h_ref.vdim, device="cpu")
    b32 = sysm.b_hat.astype(np.float32)
    relres_by = {}
    for resync in (0, 2, 3, 16):
        xr, kr, rr = ref_mg.mg_pcg(h_ref, jnp.asarray(b32),
                                   jnp.zeros(b32.shape, jnp.float32), 1e-6,
                                   100, resync_every=resync)
        x, k, relres = mg.mg_pcg(h, torch.from_numpy(b32),
                                 torch.zeros(b32.shape), 1e-6, 100,
                                 resync_every=resync)
        assert relres <= 1e-6 and abs(k - int(kr)) <= 1, (resync, k, kr)
        assert np.abs(x.numpy() - np.asarray(xr)).max() <= \
            1e-5 * np.abs(np.asarray(xr)).max()
        relres_by[resync] = (k, relres)
    # the resync replaced the recurrence residual (ending on a different
    # one) where it ran, and nowhere at 16
    for resync in (2, 3):
        assert relres_by[resync][0] > resync
        assert relres_by[resync][1] != relres_by[0][1]
    assert relres_by[16] == relres_by[0]
