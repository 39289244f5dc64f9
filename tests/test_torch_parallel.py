"""The sharding layer of the port (``pde_solver_tpu_torch.parallel``)
against the JAX package's (``pde_solver_tpu.parallel``): the 17 tests of
``tests/test_parallel.py`` other than the GSPMD operator (not ported), on
the same numpy inputs through both packages, plus the configuration.

The port runs on the CPU over 8 virtual shard devices
(``PDE_TPU_VIRTUAL_DEVICES=8``), the JAX package over the conftest's 8
virtual CPU devices.  Results are held at 1e-9 relative at float64, with
the iteration counts equal, and each test keeps its own closed-form or
unsharded check."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu import config as ref_config
from pde_solver_tpu.mesh import box_mesh as ref_box
from pde_solver_tpu.mesh import rectangle_mesh as ref_rect
from pde_solver_tpu.models import advection as ref_adv
from pde_solver_tpu.models import elasticity as ref_elast
from pde_solver_tpu.models import heat as ref_heat
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import linsolve as ref_linsolve
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu.ops.bc import all_boundary as ref_all_boundary
from pde_solver_tpu.parallel import shard as ref_psh
from pde_solver_tpu.parallel import shard_mg as ref_shard_mg
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu_torch.models import advection, elasticity, heat
from pde_solver_tpu_torch.ops import assembly, device_loop, linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.parallel import shard as psh
from pde_solver_tpu_torch.parallel import shard_mg
from pde_solver_tpu_torch.utils import kept

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = 1e-9


@pytest.fixture
def cpu8(monkeypatch):
    """The port on the CPU over 8 virtual shard devices."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "8")
    with config.config_overrides(device="cpu"):
        yield


@pytest.fixture(autouse=True)
def _eight_jax_devices():
    assert len(jax.devices()) >= 8, "the conftest gives 8 CPU devices"


def _gap(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    assert x.shape == ref.shape
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def _linear_in_x(node_shape):
    coords_x = np.linspace(0.0, 1.0, node_shape[0])
    return 20.0 * (1.0 - coords_x).reshape((-1,) + (1,) * (
        len(node_shape) - 1)) * np.ones(node_shape)


def _left_right(m, cls):
    return cls.from_masks([(m.face_mask(0, 0), 20.0),
                           (m.face_mask(0, 1), 0.0)], m.node_shape)


# ----------------------------------------------------------------------
# 1-D decomposition: the heat step, sharded CG, config routes
# ----------------------------------------------------------------------

def test_sharded_heat_step_matches_single_device(cpu8):
    cells, dt, kappa = (15, 6), 0.01, 1.3
    rng = np.random.default_rng(0)
    rm = ref_rect(*cells, (0.0, 0.0), (1.0, 1.0))
    rbc = RefBC.from_masks([(ref_all_boundary(rm), 0.0)], rm.node_shape,
                           dtype=jnp.float64)
    u0 = np.asarray(rbc.apply_values(jnp.asarray(rng.random(rm.node_shape))))
    step_r, inputs_r = ref_psh.build_sharded_heat_step(
        rm, ref_psh.device_mesh(8), kappa, dt, rbc, dtype=jnp.float64,
        tol=1e-12, maxiter=2000)
    u_ref, it_ref, _ = step_r(jnp.asarray(u0), *inputs_r)

    m = rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0))
    bc = DirichletBC.from_masks([(all_boundary(m), 0.0)], m.node_shape)
    step, inputs = psh.build_sharded_heat_step(
        m, psh.device_mesh(8), kappa, dt, bc, dtype=torch.float64,
        tol=1e-12, maxiter=2000)
    u1, iters, relres = step(u0, *inputs)
    assert relres < 1e-10 and iters == int(it_ref)
    assert _gap(u1, u_ref) <= F64
    # the same step on one shard: the unsharded Jacobi-PCG
    step1, inputs1 = psh.build_sharded_heat_step(
        m, psh.device_mesh(1), kappa, dt, bc, dtype=torch.float64,
        tol=1e-12, maxiter=2000)
    u_one, iters1, _ = step1(u0, *inputs1)
    assert iters1 == iters and _gap(u1, u_one) <= F64


def test_sharded_3d_step_runs(cpu8):
    m = box_mesh(7, 4, 4, (0, 0, 0), (1, 1, 1))   # 8 node planes along x
    bc = DirichletBC.from_masks([(all_boundary(m), 5.0)], m.node_shape)
    step, inputs = psh.build_sharded_heat_step(
        m, psh.device_mesh(8), 1.0, 0.01, bc, dtype=torch.float64, tol=1e-11)
    u0 = bc.apply_values(np.full(m.node_shape, 20.0))
    u1, iters, relres = step(u0, *inputs)
    assert relres < 1e-9 and torch.isfinite(u1).all()
    assert np.allclose(u1.numpy()[all_boundary(m)], 5.0)

    rm = ref_box(7, 4, 4, (0, 0, 0), (1, 1, 1))
    rbc = RefBC.from_masks([(ref_all_boundary(rm), 5.0)], rm.node_shape,
                           dtype=jnp.float64)
    step_r, inputs_r = ref_psh.build_sharded_heat_step(
        rm, ref_psh.device_mesh(8), 1.0, 0.01, rbc, dtype=jnp.float64,
        tol=1e-11)
    u_ref, it_ref, _ = step_r(jnp.asarray(u0), *inputs_r)
    # the port's step stops on its free rows, the JAX package's on a norm
    # the faces' 5 °C fill: the count is the port's one-shard step's
    step1, inputs1 = psh.build_sharded_heat_step(
        m, psh.device_mesh(1), 1.0, 0.01, bc, dtype=torch.float64, tol=1e-11)
    assert iters == step1(u0, *inputs1)[1] and _gap(u1, u_ref) <= F64


def test_sharded_elasticity_matches_single_device(cpu8):
    """vdim=3 block-scaled CG, 14 node planes over 8 shards (identity-row
    padding), against the JAX package's sharded CG and the port's
    unsharded CG."""
    lam, mu = elasticity.lame_parameters(210e9, 0.3, "3d")
    g = [0.0, 0.0, -9.81 * 7800.0]
    rm = ref_box(13, 5, 5, (0, 0, 0), (1.0, 0.5, 0.5))
    rcg, _ = ref_psh.build_sharded_elasticity_solve(
        rm, ref_psh.device_mesh(8), lam, mu, g,
        RefBC.from_masks([(rm.face_mask(0, 0), 0.0)], rm.node_shape, vdim=3),
        dtype=jnp.float64)
    x_ref, it_ref, _ = rcg.solve(tol=1e-12, maxiter=4000)

    m = box_mesh(13, 5, 5, (0, 0, 0), (1.0, 0.5, 0.5))
    cg, sysm = psh.build_sharded_elasticity_solve(
        m, psh.device_mesh(8), lam, mu, g,
        DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape,
                               vdim=3), dtype=torch.float64)
    assert cg.pads == (2,)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=4000)
    assert relres < 1e-10 and iters == int(it_ref)
    assert _gap(x, x_ref) <= F64
    w64 = tuple(torch.tensor(W) for W in sysm.weights)
    b = torch.tensor(sysm.b_hat)
    ref, k, _ = linsolve._cg_unit_diag(sysm.offsets, w64, b,
                                       torch.zeros_like(b), 1e-12, 4000, 3, 3)
    assert k == iters and _gap(x, ref) <= F64


def test_solve_stencil_system_sharded_config_route(monkeypatch):
    """``set_config(shard_devices=8)`` routes a solve through sharded CG
    (host sparse LU skipped) and meets the closed form u = 20 (1 − x)."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "8")
    cells = (13, 6)   # 14 node planes over 8 shards
    m = rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0))
    old = config.get_config()
    try:
        config.set_config(device="cpu", shard_devices=8)
        assert config.get_config().resolved_shard_devices() == 8
        x, st = linsolve.solve_stencil_system(
            assembly.assemble_scalar_stencil(m, "stiffness"), m,
            _left_right(m, DirichletBC), np.zeros(m.node_shape))
    finally:
        config.set_config(device=old.device, shard_devices=old.shard_devices)
    assert st.converged and int(st.iterations) > 1
    assert np.abs(x - _linear_in_x(m.node_shape)).max() < 1e-8

    rm = ref_rect(*cells, (0.0, 0.0), (1.0, 1.0))
    with ref_config.config_overrides(shard_devices=8):
        x_ref, st_ref = ref_linsolve.solve_stencil_system(
            ref_asm.assemble_scalar_stencil(rm, "stiffness"), rm,
            _left_right(rm, RefBC), np.zeros(rm.node_shape))
    assert int(st.iterations) == int(st_ref.iterations)
    assert _gap(x, x_ref) <= F64


# ----------------------------------------------------------------------
# Sharded multigrid
# ----------------------------------------------------------------------

def _mg_box(pkg_box, asm, cls, n=40):
    m = pkg_box(n, n, n, (0, 0, 0), (1.0, 1.0, 1.0))

    def builder(mc):
        return asm.assemble_scalar_stencil(mc, "stiffness"), \
            _left_right(mc, cls)

    return (m, asm.assemble_scalar_stencil(m, "stiffness"),
            _left_right(m, cls), builder)


@pytest.mark.parametrize("prec,tol,closed,parity", [
    ("f64", None, 1e-8, F64),
    ("mixed", 1e-9, 1e-6, 1e-8),
    ("mixed", None, 1e-6, F64)])
def test_sharded_mg_composes_above_threshold(cpu8, prec, tol, closed,
                                             parity):
    """Above ``mg_threshold`` a sharded request runs sharded MG-PCG (a
    handful of iterations, where plain CG needs hundreds); at "mixed" as
    the inner solves of the host float64 refinement loop.  The "mixed"
    cases are ``test_sharded_mg_mixed_precision_route`` of the JAX
    package's tests.  Its tol=1e-9 stops each package's refinement at a
    relres of ~7e-10 reached through float32 inner solves of their own
    rounding, which leaves the two fields 7.6e-9 apart (held at 1e-8); at
    the default tol (1e-11) both refine to ~2e-14 and lie 3.7e-13 apart
    (held at 1e-9)."""
    kw = dict(shard_devices=8, precision=prec)
    if tol is not None:
        kw["tol"] = tol
    m, K, bc, builder = _mg_box(box_mesh, assembly, DirichletBC)
    kept.clear_all()
    with config.config_overrides(**kw):
        x, st = linsolve.solve_stencil_system(K, m, bc, np.zeros(m.node_shape),
                                              mg_level_builder=builder)
    (h, _), = linsolve._MG_CACHE.values()
    assert all(isinstance(lv.weights, tuple) for lv in h.levels)
    assert len(shard_mg._SOLVER_CACHE) == 1
    assert st.converged and int(st.iterations) <= 60
    assert np.abs(x - _linear_in_x(m.node_shape)).max() < closed

    rm, rK, rbc, rbuilder = _mg_box(ref_box, ref_asm, RefBC)
    with ref_config.config_overrides(**kw):
        x_ref, st_ref = ref_linsolve.solve_stencil_system(
            rK, rm, rbc, np.zeros(rm.node_shape), mg_level_builder=rbuilder)
    assert int(st.iterations) == int(st_ref.iterations)
    assert _gap(x, x_ref) <= parity
    kept.clear_all()


def test_shard_hierarchy_cache_never_aliases_stale_solver(cpu8):
    """Keyless entries pin the hierarchy and reuse only the same object;
    content-keyed entries reuse across equal-content rebuilds; the mesh's
    device list and shard count are part of the key."""
    def build(n):
        mesh = box_mesh(n, n, n, (0, 0, 0), (1.0, 1.0, 1.0))
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)],
                                    mesh.node_shape)
        sysm = linsolve.prepare_system(K, mesh, bc,
                                       assembly.assemble_load(mesh), 1)

        def builder(mc):
            return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                    DirichletBC.from_masks([(all_boundary(mc), 0.0)],
                                           mc.node_shape))

        return mg.build_hierarchy(mesh, sysm, builder, vdim=1, device="cpu",
                                  dtype=torch.float32, use_kernel=False)

    dev = psh.device_mesh(8)
    shard_mg._SOLVER_CACHE.clear()
    h1 = build(16)
    s1 = shard_mg.shard_hierarchy(h1, dev)
    assert shard_mg.shard_hierarchy(h1, dev) is s1
    assert any(entry[0] is h1 for entry in shard_mg._SOLVER_CACHE.values())
    h2 = build(24)
    s2 = shard_mg.shard_hierarchy(h2, dev)
    assert s2 is not s1
    h3 = build(16)
    s3a = shard_mg.shard_hierarchy(h3, dev, key=("ck", 16))
    assert shard_mg.shard_hierarchy(build(16), dev, key=("ck", 16)) is s3a
    assert shard_mg.shard_hierarchy(h2, dev, key=("ck", 24)) is not s3a
    # four virtual shards on the same device are another mesh
    s4 = shard_mg.shard_hierarchy(h3, psh.device_mesh(4), key=("ck", 16))
    assert s4 is not s3a and s4.mesh_dev.size == 4
    # a kernel-backed hierarchy is refused
    with pytest.raises(ValueError, match="use_kernel=False"):
        shard_mg.ShardedMGSolver(h1._replace(levels=(h1.levels[0]._replace(
            weights=object()),) + h1.levels[1:]), dev)
    shard_mg._SOLVER_CACHE.clear()

    # the JAX package's contract, the same sequence
    rdev = ref_psh.device_mesh(8)
    ref_shard_mg._SOLVER_CACHE.clear()
    rm = ref_box(16, 16, 16, (0, 0, 0), (1.0, 1.0, 1.0))
    rsys = ref_linsolve.prepare_system(
        ref_asm.assemble_scalar_stencil(rm, "stiffness"), rm,
        RefBC.from_masks([(ref_all_boundary(rm), 0.0)], rm.node_shape),
        ref_asm.assemble_load(rm), 1)
    rh = ref_mg.build_hierarchy(
        rm, rsys, lambda mc: (ref_asm.assemble_scalar_stencil(mc, "stiffness"),
                              RefBC.from_masks([(ref_all_boundary(mc), 0.0)],
                                               mc.node_shape)),
        vdim=1, dtype=jnp.float32, use_pallas=False)
    assert ref_shard_mg.shard_hierarchy(rh, rdev) is \
        ref_shard_mg.shard_hierarchy(rh, rdev)
    ref_shard_mg._SOLVER_CACHE.clear()


def test_sharded_mg_solver_matches_reference(cpu8):
    """ShardedMGSolver alone on a float64 hierarchy (81 planes over 8
    shards: 7 identity rows), against the JAX package's on the same
    system: iterations equal, x̂ within 1e-9; the padded rows stay 0."""
    def parts(pkg_box, asm, cls, prep):
        m = pkg_box(80, 4, 4, (0, 0, 0), (1.0, 0.2, 0.2))

        def builder(mc):
            return asm.assemble_scalar_stencil(mc, "stiffness"), \
                _left_right(mc, cls)

        sysm = prep(asm.assemble_scalar_stencil(m, "stiffness"), m,
                    _left_right(m, cls), np.zeros(m.node_shape), 1)
        return m, sysm, builder

    m, sysm, builder = parts(box_mesh, assembly, DirichletBC,
                             linsolve.prepare_system)
    h = mg.build_hierarchy(m, sysm, builder, device="cpu",
                           dtype=torch.float64, use_kernel=False)
    solver = shard_mg.ShardedMGSolver(h, psh.device_mesh(8))
    assert solver.n_pad == 7
    x, k, relres = shard_mg.solve_mg_sharded(solver, sysm.b_hat, None,
                                             1e-11, 300)
    assert relres <= 1e-11 and solver.relres(x, sysm.b_hat) < 1e-9

    rm, rsys, rbuilder = parts(ref_box, ref_asm, RefBC,
                               ref_linsolve.prepare_system)
    rh = ref_mg.build_hierarchy(rm, rsys, rbuilder, dtype=jnp.float64,
                                use_pallas=False)
    rsolver = ref_shard_mg.ShardedMGSolver(rh, ref_psh.device_mesh(8))
    x_ref, k_ref, _ = ref_shard_mg.solve_mg_sharded(rsolver, rsys.b_hat,
                                                    None, 1e-11, 300)
    assert k == int(k_ref) and _gap(x, x_ref) <= F64


# ----------------------------------------------------------------------
# Sharded scans
# ----------------------------------------------------------------------

def test_sharded_transient_scan_matches_single_device(cpu8):
    """22 node rows over 8 shards: the sharded θ-scan against the port's
    unsharded scan and the JAX package's sharded one."""
    def problem(pkg_rect, pkg_heat):
        m = pkg_rect(21, 8, (0.0, 0.0), (1.0, 1.0))
        return pkg_heat.HeatProblem(
            mesh=m, diffusivity=1.0,
            bc_builder=lambda mm: [(mm.face_mask(0, 0), 20.0),
                                   (mm.face_mask(0, 1), 0.0)],
            T_initial=0.0, dt=0.01, num_steps=12)

    p = problem(rectangle_mesh, heat)
    _, plain, plain_info = heat.solve_heat_problem(p)
    with config.config_overrides(shard_devices=8):
        _, sh, info = heat.solve_heat_problem(p)
    assert info["relative_residual"] <= 1e-9
    assert info["cg_iterations"] == plain_info["cg_iterations"]
    assert _gap(sh, plain) <= F64
    with ref_config.config_overrides(shard_devices=8):
        _, ref, ref_info = ref_heat.solve_heat_problem(
            problem(ref_rect, ref_heat))
    # the port's steps stop on their free rows, the JAX package's on a norm
    # the 20 °C face fills: the count is the port's sharded per-step path's
    assert info["cg_iterations"] == _per_step_iterations(
        heat.solve_heat_problem, p)
    assert _gap(sh, ref) <= F64


def _vector_block(pkg_rect, asm, pkg_elast, cls, with_v0=False):
    m = pkg_rect(13, 6, (0.0, 0.0), (1.0, 1.0))
    lam, mu = pkg_elast.lame_parameters(1e6, 0.3, "plane_stress")
    K = asm.assemble_elasticity_stencil(m, lam, mu)
    M = pkg_elast.assemble_vector_mass(m, 100.0)
    bc = cls.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape, vdim=2)
    b = asm.assemble_vector_load(m, np.array([0.0, -10.0]))
    u0 = np.zeros(m.node_shape + (2,))
    return (K, M, m, bc, b, u0) + ((np.zeros_like(u0),) if with_v0 else ())


def test_sharded_transient_scan_vector_block(cpu8):
    """The θ-scan with block (vdim=2) scaling, sharded."""
    args = _vector_block(rectangle_mesh, assembly, elasticity, DirichletBC)
    kw = dict(dt=1e-3, num_steps=8, vdim=2)
    plain = timestepping.run_transient(*args, **kw)
    with config.config_overrides(shard_devices=8):
        sh = timestepping.run_transient(*args, **kw)
    assert sh.total_cg_iterations == plain.total_cg_iterations
    assert _gap(sh.values, plain.values) <= F64
    rargs = _vector_block(ref_rect, ref_asm, ref_elast, RefBC)
    with ref_config.config_overrides(shard_devices=8):
        ref = ref_ts.run_transient(*rargs, **kw)
    assert sh.total_cg_iterations == ref.total_cg_iterations
    assert _gap(sh.values, ref.values) <= F64
    assert np.array_equal(sh.times, ref.times)


def test_sharded_cnab2_advection_matches_single_device(cpu8):
    """CNAB2's previous-state carry through the sharded scan."""
    def problem(pkg_rect, pkg_adv):
        return pkg_adv.AdvectionProblem(
            mesh=pkg_rect(21, 8, (0.0, 0.0), (1.0, 1.0)),
            velocity=[0.8, -0.3], diffusivity=0.02, initial_type="gaussian",
            pulse_center=(0.4, 0.6), pulse_width=0.15, dt=0.005,
            num_steps=10)

    p = problem(rectangle_mesh, advection)
    _, plain, plain_info = advection.solve_advection_problem(p)
    assert plain_info["scheme"] == "cnab2"
    with config.config_overrides(shard_devices=8):
        _, sh, info = advection.solve_advection_problem(p)
    assert info["converged"] and _gap(sh, plain) <= F64
    with ref_config.config_overrides(shard_devices=8):
        _, ref, ref_info = ref_adv.solve_advection_problem(
            problem(ref_rect, ref_adv))
    assert info["cg_iterations"] == ref_info["cg_iterations"]
    assert _gap(sh, ref) <= F64


def _per_step_iterations(solve, p):
    """The iterations of ``solve(p)`` on 8 shards with every scan step
    solved on its own (``device_loop._per_step``)."""
    with config.config_overrides(shard_devices=8), device_loop._per_step():
        return solve(p)[2]["cg_iterations"]


def test_sharded_time_mod_matches_single_device(cpu8):
    """Sinusoidal Dirichlet and source driving inside the sharded scan."""
    def problem(pkg_rect, pkg_heat):
        m = pkg_rect(21, 8, (0.0, 0.0), (1.0, 1.0))
        return pkg_heat.HeatProblem(
            mesh=m, diffusivity=1.0,
            bc_builder=lambda mm: [(mm.face_mask(0, 0), 20.0),
                                   (mm.face_mask(0, 1), 0.0)],
            T_initial=0.0, dt=0.01, num_steps=12,
            bc_amp_pairs=[(m.face_mask(0, 0), 5.0)],
            source_type="constant", source_value=1.0, source_amp=0.5,
            mod_omega=6.0, mod_phase=0.3)

    p = problem(rectangle_mesh, heat)
    _, plain, _ = heat.solve_heat_problem(p)
    with config.config_overrides(shard_devices=8):
        _, sh, info = heat.solve_heat_problem(p)
    assert info["relative_residual"] <= 1e-6 and _gap(sh, plain) <= F64
    assert np.abs(plain[1:] - plain[:-1]).max() > 0.0
    with ref_config.config_overrides(shard_devices=8):
        _, ref, ref_info = ref_heat.solve_heat_problem(
            problem(ref_rect, ref_heat))
    # the count is the port's own (steps stopped on their free rows)
    assert info["cg_iterations"] == _per_step_iterations(
        heat.solve_heat_problem, p)
    assert _gap(sh, ref) <= F64


def test_sharded_newmark_matches_single_device(cpu8):
    """run_newmark sharded (vdim=2), displacements and velocities."""
    args = _vector_block(rectangle_mesh, assembly, elasticity, DirichletBC,
                         with_v0=True)
    kw = dict(dt=1e-3, num_steps=8, vdim=2)
    plain = timestepping.run_newmark(*args, **kw)
    with config.config_overrides(shard_devices=8):
        sh = timestepping.run_newmark(*args, **kw)
    assert sh.total_cg_iterations == plain.total_cg_iterations
    assert _gap(sh.values, plain.values) <= F64
    assert _gap(sh.velocities, plain.velocities) <= F64
    rargs = _vector_block(ref_rect, ref_asm, ref_elast, RefBC, with_v0=True)
    with ref_config.config_overrides(shard_devices=8):
        ref = ref_ts.run_newmark(*rargs, **kw)
    assert sh.total_cg_iterations == int(ref.total_cg_iterations)
    assert _gap(sh.values, ref.values) <= F64
    assert _gap(sh.velocities, ref.velocities) <= F64


# ----------------------------------------------------------------------
# 2-D decomposition (grid axes 0 and 1 over an a×b mesh)
# ----------------------------------------------------------------------

def test_local_stencil_apply_2d_mesh_matches_dense(cpu8):
    """The halo apply on a 4×2 mesh equals the dense apply, corner
    couplings of the simplicial P1 stencil included (they arrive through
    the axis-0-extended blocks)."""
    m = box_mesh(7, 5, 4, (0, 0, 0), (1.0, 1.0, 1.0))   # nodes (8, 6, 5)
    K = assembly.assemble_scalar_stencil(m, "stiffness")
    offsets = tuple(sorted(K))
    assert any(o[0] != 0 and o[1] != 0 for o in offsets)
    x = np.random.default_rng(3).random(m.node_shape)
    dev = psh.device_mesh(shape=(4, 2))
    assert dev.axis_names == (psh.AXIS, psh.AXIS1)
    w = tuple(psh.shard(K[o], dev, torch.float64) for o in offsets)
    y = psh.gather(psh.local_stencil_apply(offsets, w,
                                           psh.shard(x, dev, torch.float64)))
    y_ref = linsolve.np_stencil_apply(K, x, 3)
    assert np.allclose(y.numpy(), y_ref, atol=1e-12)
    # the extended block of an inner shard holds its diagonal neighbour's
    # corner node, which only the transitive exchange brings
    xs = psh.shard(x, dev, torch.float64)
    ext = psh.halo_exchange_axis(psh.halo_exchange(xs), 1, 1)
    assert ext.parts[2].shape == (4, 5, 5)      # shard (1, 0)
    assert ext.parts[2][0, -1, 0] == x[1, 3, 0]  # from shard (0, 1)


def test_sharded_cg_2d_mesh_matches_single_device(cpu8):
    """ShardedScaledCG over a 4×2 mesh, extents (14, 9) padded on both
    decomposed axes, vdim=1."""
    def system(pkg_rect, asm, cls, prep):
        m = pkg_rect(13, 8, (0.0, 0.0), (1.0, 1.0))
        return prep(asm.assemble_scalar_stencil(m, "stiffness"), m,
                    _left_right(m, cls), asm.assemble_load(m), 1)

    sysm = system(rectangle_mesh, assembly, DirichletBC,
                  linsolve.prepare_system)
    cg = psh.ShardedScaledCG(sysm, 2, 1, psh.device_mesh(shape=(4, 2)),
                             dtype=torch.float64)
    assert cg.pads == (2, 1)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=4000)
    assert relres < 1e-10
    b = torch.tensor(sysm.b_hat)
    ref, k, _ = linsolve._cg_unit_diag(
        sysm.offsets, tuple(torch.tensor(W) for W in sysm.weights), b,
        torch.zeros_like(b), 1e-12, 4000, 2, 1)
    assert k == iters and _gap(x, ref) <= F64
    rsys = system(ref_rect, ref_asm, RefBC, ref_linsolve.prepare_system)
    rcg = ref_psh.ShardedScaledCG(rsys, 2, 1,
                                  ref_psh.device_mesh(shape=(4, 2)),
                                  dtype=jnp.float64)
    x_ref, it_ref, _ = rcg.solve(tol=1e-12, maxiter=4000)
    assert iters == int(it_ref) and _gap(x, x_ref) <= F64


def test_sharded_elasticity_2d_mesh_vdim3(cpu8):
    """vdim=3 block-scaled CG on a 4×2 mesh, nodes (10, 6, 5): padded both
    ways."""
    g = np.array([0.0, 0.0, -9.81 * 7800.0])

    def system(pkg_box, asm, pkg_elast, cls, prep):
        lam, mu = pkg_elast.lame_parameters(210e9, 0.3, "3d")
        m = pkg_box(9, 5, 4, (0, 0, 0), (1.0, 0.5, 0.5))
        bc = cls.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape, vdim=3)
        return prep(asm.assemble_elasticity_stencil(m, lam, mu), m, bc,
                    asm.assemble_vector_load(m, g), 3)

    sysm = system(box_mesh, assembly, elasticity, DirichletBC,
                  linsolve.prepare_system)
    cg = psh.ShardedScaledCG(sysm, 3, 3, psh.device_mesh(shape=(4, 2)),
                             dtype=torch.float64)
    assert cg.pads == (2, 0)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=6000)
    assert relres < 1e-10 and cg.relres(x) < 1e-9
    b = torch.tensor(sysm.b_hat)
    ref, k, _ = linsolve._cg_unit_diag(
        sysm.offsets, tuple(torch.tensor(W) for W in sysm.weights), b,
        torch.zeros_like(b), 1e-12, 6000, 3, 3)
    assert k == iters and _gap(x, ref) <= F64
    rsys = system(ref_box, ref_asm, ref_elast, RefBC,
                  ref_linsolve.prepare_system)
    rcg = ref_psh.ShardedScaledCG(rsys, 3, 3,
                                  ref_psh.device_mesh(shape=(4, 2)),
                                  dtype=jnp.float64)
    x_ref, it_ref, _ = rcg.solve(tol=1e-12, maxiter=6000)
    assert iters == int(it_ref) and _gap(x, x_ref) <= F64


def test_shard_grid_config_route(cpu8):
    """``shard_grid="4,2"`` routes a solve through the 2-D decomposed CG
    and meets the closed form."""
    cells = (13, 9)
    m = rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0))
    with config.config_overrides(shard_grid="4,2", host_direct_threshold=0):
        assert config.get_config().resolved_shard_devices() == 8
        x, st = linsolve.solve_stencil_system(
            assembly.assemble_scalar_stencil(m, "stiffness"), m,
            _left_right(m, DirichletBC), np.zeros(m.node_shape))
    assert st.converged
    assert np.abs(x - _linear_in_x(m.node_shape)).max() < 1e-8
    rm = ref_rect(*cells, (0.0, 0.0), (1.0, 1.0))
    with ref_config.config_overrides(shard_grid="4,2",
                                     host_direct_threshold=0):
        x_ref, st_ref = ref_linsolve.solve_stencil_system(
            ref_asm.assemble_scalar_stencil(rm, "stiffness"), rm,
            _left_right(rm, RefBC), np.zeros(rm.node_shape))
    assert int(st.iterations) == int(st_ref.iterations)
    assert _gap(x, x_ref) <= F64


@pytest.mark.parametrize("grid,want_grid,want_n", [
    ("16,4", None, 0),     # a·b above the devices
    ("4,2", (4, 2), 8),
    ("4x2", (4, 2), 8),
    ("8,1", None, 0),      # b < 2
    ("4;2", None, 0),      # malformed
])
def test_shard_grid_falls_back_when_unfactorable(cpu8, grid, want_grid,
                                                 want_n):
    """An unusable shard_grid resolves to None, the 1-D split (with
    ``shard_devices`` unset: no sharding), as in the JAX package, never
    raising; a usable one alone implies a·b shards."""
    with config.config_overrides(shard_grid=grid):
        assert config.get_config().resolved_shard_grid() == want_grid
        assert config.get_config().resolved_shard_devices() == want_n
    with config.config_overrides(shard_grid=grid, shard_devices=4):
        assert config.get_config().resolved_shard_devices() == 4
    with ref_config.config_overrides(shard_grid=grid):
        assert ref_config.get_config().resolved_shard_grid() == want_grid
        assert ref_config.get_config().resolved_shard_devices() == want_n


# ----------------------------------------------------------------------
# Configuration
# ----------------------------------------------------------------------

@pytest.mark.parametrize("virtual,request_n,want", [
    ("8", 4, 4), ("8", 16, 8), ("2", 4, 2), ("", 4, 1), ("8", 1, 0),
    ("8", 0, 0)])
def test_shard_devices_clip_to_the_available_devices(monkeypatch, virtual,
                                                     request_n, want):
    """The request is clipped to ``available_devices()``: one CPU device
    without virtual ones (the solve then runs unsharded, logged), n
    virtual copies of the configured device with them."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", virtual)
    with config.config_overrides(device="cpu", shard_devices=request_n):
        cfg = config.get_config()
        assert cfg.resolved_shard_devices() == want
        devs = psh.available_devices()
    assert devs == [torch.device("cpu")] * (int(virtual) if virtual else 1)
    # the JAX package clips to its device count alike
    with ref_config.config_overrides(shard_devices=request_n):
        n_ref = ref_config.get_config().resolved_shard_devices()
    assert n_ref == (0 if request_n <= 1 else min(request_n, 8))


def test_unsharded_solve_when_the_clip_leaves_one_device(monkeypatch,
                                                         caplog):
    """No virtual devices on the CPU: a request for 4 shards runs the
    unsharded solve (host sparse LU here), and says so."""
    monkeypatch.delenv("PDE_TPU_VIRTUAL_DEVICES", raising=False)
    m = rectangle_mesh(13, 6, (0.0, 0.0), (1.0, 1.0))
    from pde_solver_tpu_torch.utils.observability import get_logger

    get_logger().propagate = True
    try:
        with config.config_overrides(device="cpu", shard_devices=4), \
                caplog.at_level("WARNING", logger="pde_solver_tpu_torch"):
            x, st = linsolve.solve_stencil_system(
                assembly.assemble_scalar_stencil(m, "stiffness"), m,
                _left_right(m, DirichletBC), np.zeros(m.node_shape))
    finally:
        get_logger().propagate = False
    assert st.converged and int(st.iterations) == 1   # host sparse LU
    assert "clipped to the 1 available" in caplog.text


def test_mesh_needs_its_devices(cpu8):
    with pytest.raises(ValueError, match="16 shards"):
        psh.device_mesh(16)
    with pytest.raises(ValueError, match="4x4"):
        psh.device_mesh(shape=(4, 4))
    with pytest.raises(ValueError, match="do not divide"):
        psh.shard(np.zeros((9, 3)), psh.device_mesh(8), torch.float64)


def test_config_defaults_and_environment():
    """``mg_inner_tol`` defaults to the JAX package's 1e-4, and
    ``PDE_TPU_SHARD_DEVICES`` / ``PDE_TPU_SHARD_GRID`` reach ``_GLOBAL``
    (read at import, as in the JAX package: a fresh process)."""
    assert config.SolverConfig().mg_inner_tol == 1e-4
    assert config.SolverConfig().mg_inner_tol == \
        ref_config.SolverConfig().mg_inner_tol
    env = dict(os.environ, PDE_TPU_SHARD_DEVICES="4",
               PDE_TPU_SHARD_GRID="2,2", PDE_TPU_DEVICE="cpu",
               PDE_TPU_VIRTUAL_DEVICES="4")
    out = subprocess.run(
        [sys.executable, "-c",
         "from pde_solver_tpu_torch import config as c; g = c.get_config(); "
         "print(g.shard_devices, g.shard_grid, g.resolved_shard_grid(), "
         "g.resolved_shard_devices())"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "4 2,2 (2, 2) 4"


@pytest.mark.parametrize("cells", [(32, 8, 8), (64, 8, 8)])
def test_sharded_f64_cantilever_matches_reference(cpu8, cells, tmp_path):
    """The flagship's shape class at "f64" on 4 shards through the API:
    sharded MG-PCG with the iterations of the JAX package's sharded run
    and its von Mises within 1e-9.  Both packages' sharded solvers keep
    the dense coarsest inverse that their unsharded float64 ``solve_mg``
    drops, so they take fewer iterations than the unsharded solves (27
    against 30 at 32×8×8, 26 against 34 at 64×8×8 in the JAX package).
    The unsharded solves' fields agree to 1e-9, their iterations within
    4: the 60-iteration CG coarse solve inside a flexible PCG carries each
    package's rounding into the iteration count (30 and 30 at 32×8×8, 34
    in the JAX package against 38 in the port at 64×8×8)."""
    from pde_solver_tpu import api as ref_api
    from pde_solver_tpu.fields import load_field as ref_load
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.fields import load_field

    kw = dict(Lx=1.0, Ly=0.2, Lz=0.2, nx=cells[0], ny=cells[1], nz=cells[2],
              E=210e9, nu=0.3, body_fz=-9.81 * 7800)
    out = {}
    for n in (4, 0):
        cfg = dict(precision="f64", shard_devices=n, host_direct_threshold=0,
                   mg_threshold=100)
        with config.config_overrides(**cfg):
            r = api.solve_elasticity_3D_static(**kw,
                                               data_dir=str(tmp_path / "p"))
        with ref_config.config_overrides(**cfg):
            r_ref = ref_api.solve_elasticity_3D_static(
                **kw, data_dir=str(tmp_path / "r"))
        st, st_ref = r.meta["solver_stats"], r_ref.meta["solver_stats"]
        assert st["converged"] and st_ref["converged"]
        out[n] = (st["cg_iterations"], st_ref["cg_iterations"])
        assert _gap(load_field(r.data_file).values_array(),
                    ref_load(r_ref.data_file).values_array()) <= F64
    assert out[4][0] == out[4][1]
    assert abs(out[0][0] - out[0][1]) <= 4
    assert out[4][0] < out[0][0] and out[4][1] < out[0][1]


def test_chip_smoke_shard_phase_rehearsal(tmp_path):
    """``chip_smoke.shard_phase`` on the CPU: the eight legs at the dry-run
    record's sizes, each as its device program and uncaptured, and a
    16×4×4 flagship on 4 shards at "f64" and "mixed", its first inner
    solve again both ways (no launch is counted here): every check of the
    phase holds."""
    import time

    import chip_smoke as cs
    from pde_solver_tpu_torch import api

    d = str(tmp_path)
    flag = dict(cs.FLAGSHIP, nx=16, ny=4, nz=4)

    def counted(label, fn):
        t = time.perf_counter()
        res = fn()
        return res, {}, time.perf_counter() - t

    with config.config_overrides(device="cpu", host_direct_threshold=0,
                                 mg_threshold=100):
        vm_calls, unspy = cs.spy_von_mises()
        try:
            with config.config_overrides(precision="f64"):
                r64 = api.solve_elasticity_3D_static(**flag, data_dir=d)
        finally:
            unspy()
        with config.config_overrides(precision="mixed"):
            vm_dense = cs.field(api.solve_elasticity_3D_static(
                **flag, data_dir=d))[0]
        out = cs.shard_phase(
            api, counted, d, vm_calls[0]["u"],
            r64.meta["solver_stats"]["cg_iterations"], vm_dense, "cpu", REPO,
            flagship=flag, device="cpu", relres_tol=cs.FLOOR_RELRES_TOL)
    assert os.environ.get("PDE_TPU_VIRTUAL_DEVICES") is None
    assert [leg["record"] for leg in out["legs"].values()] == \
        [20, 412, 24, 208, 84, 66, 80, 202]
    assert all(leg["gap"] <= cs.SHARD_LEG_TOL for leg in out["legs"].values())
    # each sharded loop as its device program and uncaptured: the same
    # iterations and reads, a field gap of 0
    for leg in out["legs"].values():
        (k, reads, _), (k0, reads0, _) = leg["ways"].values()
        assert leg["way_gap"] == 0.0 and k == k0 > 0 and reads == reads0
    for prec in ("f64", "mixed"):
        row = out[f"flagship sharded {prec}"]
        assert row["inner_gap"] == 0.0
        assert row["inner_program"][:2] == row["inner_uncaptured"][:2]
    assert out["flagship sharded f64"]["inner_program"][0] == \
        out["flagship sharded f64"]["iterations"]
    assert out["flagship sharded f64"]["u_gap"] <= cs.SHARD_F64_TOL
    # two layers of 5×5 nodes × 3 components across each of 3 interfaces
    assert out["flagship sharded f64"]["halo_bytes"] == 2 * 3 * 5 * 5 * 3 * 8
    assert out["flagship sharded mixed"]["halo_bytes"] == 2 * 3 * 5 * 5 * 3 * 4
    assert out["flagship sharded mixed"]["vm_gap"] <= cs.SHARD_VM_TOL
