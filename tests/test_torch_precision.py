"""The precision scheme of the port against the JAX package: the float64
and float32 branches of the static solve, ``solve_mg`` on float64
hierarchies, float64 transient, advection, wave and Newmark scans,
``set_config`` and the new configuration fields; then the cases of the
JAX package's ``test_core_fem.py``, ``test_mixed_precision.py``,
``test_multigrid.py``,
``test_thermal.py``, ``test_models.py``, ``test_traction.py``,
``test_elasticity.py`` and ``test_convergence.py`` that solve, run through
the port at the JAX package's precision (the CPU's "auto", float64, unless
the case names another).

Bounds: 1e-9 relative for float64 against float64, 1e-5 for float32
against float32; the closed forms keep the JAX package's own bounds."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import reference_fem as ref_fem
import test_models as ref_tm
from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import linsolve as ref_linsolve
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch import api, config
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models import heat
from pde_solver_tpu_torch.ops import assembly, device_loop, linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.ops.stencil_kernels import FlatStencilOperator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = config.SolverConfig(device="cpu")          # "auto" → float64
BEAM = dict(Lx=1.0, Ly=0.2, Lz=0.2, body_fz=-7.65e4)
LAM, MU = 1.2115384615384616e11, 8.076923076923077e10  # E=210e9, ν=0.3
# a mesh this small takes the device path, and multigrid where it can
DEVICE_PATH = dict(host_direct_threshold=0, mg_threshold=100,
                   transient_mg_threshold=100)


@pytest.fixture(autouse=True)
def _cpu():
    with config.config_overrides(device="cpu"):
        yield


def _gap(v, v_ref):
    return np.abs(v - v_ref).max() / np.abs(v_ref).max()


def _run(tool, tmp_path, cfg=None, **kw):
    """One tool through both packages under the same settings (the port on
    the CPU); returns (port, reference) as (values, times, meta)."""
    out = []
    for pkg, conf, load in ((api, config, load_field),
                            (ref_api, ref_config, ref_load)):
        with conf.config_overrides(**(cfg or {})):
            r = getattr(pkg, tool)(**kw, data_dir=str(tmp_path / pkg.__name__))
        f = load(r.data_file)
        out.append((f.values_array(), f.times_array(), r.meta))
    return out


def _same_iterations(k, k_ref):
    """Iteration counts of one float64 solve in both packages: rounding
    differences move the last step of a long ill-conditioned solve (the
    cantilever's 600 CG iterations end 2 apart), within 1 % or 2."""
    return abs(int(k) - int(k_ref)) <= max(2, int(k_ref) // 100)


def _hold_f64(port, ref, iterations=None):
    """The port's answer against the reference's; its iterations against
    the reference's, or against ``iterations`` (the port's own count of
    the same input) where given."""
    (v, t, meta), (v_ref, t_ref, meta_ref) = port, ref
    s, s_ref = meta["solver_stats"], meta_ref["solver_stats"]
    assert s["converged"] and s_ref["converged"], (s, s_ref)
    assert s["convergence_target"] == s_ref["convergence_target"]
    if iterations is not None:
        assert s["cg_iterations"] == iterations, (s["cg_iterations"],
                                                  iterations)
    else:
        assert _same_iterations(s["cg_iterations"], s_ref["cg_iterations"]), (
            s["cg_iterations"], s_ref["cg_iterations"])
    assert v.shape == v_ref.shape and np.array_equal(t, t_ref)
    assert _gap(v, v_ref) <= 1e-9, _gap(v, v_ref)


# ----------------------------------------------------------------------
# Configuration
# ----------------------------------------------------------------------

@pytest.mark.parametrize("field", [
    "transient_refine_rounds", "snapshot_dtype", "checkpoint_dir",
    "mg_maxiter", "transient_checkpoint_every", "tol", "inner_tol",
    "transient_inner_tol", "refine_rounds", "accuracy_target",
    "snapshot_budget_bytes", "mg_threshold", "host_direct_threshold"])
def test_config_defaults_match_reference(field):
    assert getattr(config.SolverConfig(), field) == \
        getattr(ref_config.SolverConfig(), field)


def test_set_config_replaces_the_global_and_overrides_win():
    """Run in a fresh context, outside the scoped CPU override."""
    import contextvars

    old = config._GLOBAL

    def body():
        new = config.set_config(precision="f32", checkpoint_dir="ckpt")
        assert config.get_config() is new and new.device == old.device
        with config.config_overrides(precision="f64") as cfg:
            assert cfg.precision == "f64" and cfg.checkpoint_dir == "ckpt"
        assert config.get_config().precision == "f32"

    try:
        contextvars.Context().run(body)
    finally:
        config._GLOBAL = old


@pytest.mark.parametrize("env,field,value", [
    ("PDE_TPU_CHECKPOINT_DIR", "checkpoint_dir", "ckpt_here"),
    ("PDE_TPU_CHECKPOINT_EVERY", "transient_checkpoint_every", 3),
    ("PDE_TPU_PRECISION", "precision", "f32"),
])
def test_environment_sets_the_process_config(env, field, value):
    code = ("from pde_solver_tpu_torch import config;"
            f"print(repr(config.get_config().{field}))")
    envs = {k: v for k, v in os.environ.items()
            if not k.startswith("PDE_TPU_")}
    envs[env] = str(value)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=envs,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == repr(value)


# ----------------------------------------------------------------------
# Static solves: the float64 and float32 branches
# ----------------------------------------------------------------------

def _poisson(cells, pkg="port", value=5.0):
    """Steady heat with a unit source and Dirichlet ``value`` all round:
    (stencil, mesh, bc, rhs, level builder) of either package."""
    if pkg == "port":
        mk, asm, BC = ((box_mesh if len(cells) == 3 else rectangle_mesh),
                       assembly, DirichletBC)
    else:
        mk, asm, BC = ((ref_mesh.box_mesh if len(cells) == 3
                        else ref_mesh.rectangle_mesh), ref_asm, RefBC)
    mesh = mk(*cells, (0.0,) * len(cells), (1.0,) * len(cells))
    K = asm.assemble_scalar_stencil(mesh, "stiffness")
    bc = BC.from_masks([(mesh.boundary_mask(), value)], mesh.node_shape)

    def builder(mc):
        return (asm.assemble_scalar_stencil(mc, "stiffness"),
                BC.from_masks([(mc.boundary_mask(), value)], mc.node_shape))

    return K, mesh, bc, asm.assemble_load(mesh), builder


@pytest.mark.parametrize("case,cells,cfg", [
    ("CG 2D", (24, 20), dict(host_direct_threshold=0)),
    ("MG-PCG 3D", (12, 12, 12), dict(host_direct_threshold=0,
                                     mg_threshold=100)),
    ("f32 CG 3D", (12, 12, 12), dict(host_direct_threshold=0,
                                     precision="f32", inner_tol=1e-7)),
])
def test_static_scalar_branch_matches_reference(case, cells, cfg):
    """The same numpy system through both packages' facade: float64 CG and
    MG-PCG (``solve_mg``) within 1e-9 and the same iterations; the float32
    branch (CG on the flat operator, at max(inner_tol, 1e-7)) within
    1e-5."""
    out = []
    for pkg, solve, conf in (("port", linsolve.solve_stencil_system, config),
                             ("ref", ref_linsolve.solve_stencil_system,
                              ref_config)):
        K, mesh, bc, b, builder = _poisson(cells, pkg)
        with conf.config_overrides(**cfg):
            out.append(solve(K, mesh, bc, b, mg_level_builder=builder))
    (x, st), (x_ref, st_ref) = out
    assert bool(st.converged) and bool(st_ref.converged)
    assert st.target == st_ref.target
    if case.startswith("f32"):
        assert st.target == max(config.SolverConfig().accuracy_target, 1e-7)
        assert _gap(x, x_ref) <= 1e-5, _gap(x, x_ref)
    else:
        assert _same_iterations(st.iterations, st_ref.iterations)
        assert _gap(x, x_ref) <= 1e-9, _gap(x, x_ref)


def test_f32_branch_iterates_on_the_flat_operator(monkeypatch):
    built = []
    orig = linsolve._static_flat_op

    def spy(*a, **kw):
        op = orig(*a, **kw)
        built.append(op)
        return op

    monkeypatch.setattr(linsolve, "_static_flat_op", spy)
    K, mesh, bc, b, builder = _poisson((8, 8, 8))
    with config.config_overrides(precision="f32", host_direct_threshold=0,
                                 mg_threshold=100):
        linsolve._MG_CACHE.clear()
        _, st = linsolve.solve_stencil_system(K, mesh, bc, b,
                                              mg_level_builder=builder)
    assert len(built) == 1 and isinstance(built[0], FlatStencilOperator)
    assert bool(st.converged) and not linsolve._MG_CACHE  # no hierarchy


@pytest.mark.parametrize("case,kw,cfg", [
    # 8,019 DOF: above host LU, below mg_threshold — float64 CG under the
    # CPU's default "auto", no precision set
    ("auto CG", dict(nx=32, ny=8, nz=8), {}),
    ("f64 MG-PCG", dict(nx=8, ny=4, nz=4), dict(precision="f64",
                                                 **DEVICE_PATH)),
])
def test_static_elasticity_f64_matches_reference(case, kw, cfg, tmp_path):
    port, ref = _run("solve_elasticity_3D_static", tmp_path, cfg,
                     E=210e9, nu=0.3, **BEAM, **kw)
    assert port[2]["solver_stats"]["num_dofs"] > 4000 or cfg
    _hold_f64(port, ref)


@pytest.mark.parametrize("cells", [(8, 4, 4), (16, 8, 8)])
def test_static_elasticity_f32_matches_reference(cells, tmp_path):
    """The flagship's float32 route at a small width: the vdim-3 cantilever
    by flat CG at the default inner_tol (1e-4).  The two packages' float32
    iterations part after a few hundred steps, so the fields are held
    through their gap to each package's own float64 field: the two gaps
    agree within 25 %, and the fields differ from each other by less than
    either differs from float64."""
    kw = dict(E=210e9, nu=0.3, nx=cells[0], ny=cells[1], nz=cells[2], **BEAM)
    port, ref = _run("solve_elasticity_3D_static", tmp_path,
                     dict(precision="f32", host_direct_threshold=0), **kw)
    port64, ref64 = _run("solve_elasticity_3D_static", tmp_path / "f64",
                         dict(precision="f64", host_direct_threshold=0), **kw)
    s, s_ref = port[2]["solver_stats"], ref[2]["solver_stats"]
    assert s["converged"] and s_ref["converged"], (s, s_ref)
    assert s["convergence_target"] == s_ref["convergence_target"] == 1e-4
    k, k_ref = s["cg_iterations"], s_ref["cg_iterations"]
    assert abs(k - k_ref) <= 0.1 * k_ref, (k, k_ref)
    gap, gap_ref = _gap(port[0], port64[0]), _gap(ref[0], ref64[0])
    assert abs(gap - gap_ref) <= 0.25 * gap_ref, (gap, gap_ref)
    assert _gap(port[0], ref[0]) <= min(gap, gap_ref)
    assert _gap(port64[0], ref64[0]) <= 1e-9


def _cantilever(cells, pkg):
    mk, asm, BC = ((box_mesh, assembly, DirichletBC) if pkg == "port"
                   else (ref_mesh.box_mesh, ref_asm, RefBC))
    mesh = mk(*cells, (0, 0, 0), (1.0, 0.2, 0.2))

    def make(m):
        return (asm.assemble_elasticity_stencil(m, LAM, MU),
                BC.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape,
                              vdim=3))

    K, bc = make(mesh)
    return K, mesh, bc, asm.assemble_vector_load(
        mesh, np.array([0, 0, -7.65e4])), make


@pytest.mark.parametrize("case,cells,cfg", [
    ("CG", (32, 8, 8), dict(host_direct_threshold=0)),
    ("MG-PCG", (16, 8, 8), dict(precision="f64", **DEVICE_PATH)),
])
def test_f64_relres_is_the_true_residual(case, cells, cfg):
    """A deliberate difference: the port's float64 branch reports the true
    ‖b̂ − Â x̂‖/‖b̂‖, the JAX package CG's recurrence, which on the
    cantilever reads below ``tol`` while the true residual stays above
    it."""
    out = []
    for pkg, solve, conf in (("port", linsolve.solve_stencil_system, config),
                             ("ref", ref_linsolve.solve_stencil_system,
                              ref_config)):
        K, mesh, bc, b, make = _cantilever(cells, pkg)
        with conf.config_overrides(**cfg):
            out.append(solve(K, mesh, bc, b, vdim=3, mg_level_builder=make))
    (x, st), (_, st_ref) = out
    tol = CPU.tol
    assert float(st_ref.relative_residual) <= tol
    assert float(st.relative_residual) > tol
    assert bool(st.converged) and bool(st_ref.converged)
    if case == "CG":   # well above the float64 floor: one more evaluation
        K, mesh, bc, b, _ = _cantilever(cells, "port")
        sysm = linsolve.prepare_system(K, mesh, bc, b, 3)
        r = sysm.b_hat - linsolve.np_stencil_apply(
            dict(zip(sysm.offsets, sysm.weights)), sysm.to_hat_x(x), 3, 3)
        host = np.linalg.norm(r) / np.linalg.norm(sysm.b_hat)
        assert abs(float(st.relative_residual) - host) <= 1e-2 * host


# ----------------------------------------------------------------------
# solve_mg and the float64 hierarchy
# ----------------------------------------------------------------------

def _systems(kind):
    """The same prepared system (port and JAX package) and both builders:
    a scalar Poisson box or a block-scaled elasticity cantilever."""
    out = []
    for mk, asm_mod, BC, prep in (
            (box_mesh, assembly, DirichletBC, linsolve.prepare_system),
            (ref_mesh.box_mesh, ref_asm, RefBC, ref_linsolve.prepare_system)):
        if kind == "scalar":
            mesh = mk(8, 8, 8, (0, 0, 0), (1.0, 1.0, 1.0))
            vdim = 1

            def make(m, asm=asm_mod, BC=BC):
                return (asm.assemble_scalar_stencil(m, "stiffness"),
                        BC.from_masks([(m.boundary_mask(), 0.0)],
                                      m.node_shape))
            b = asm_mod.assemble_load(mesh)
        else:
            mesh = mk(8, 4, 4, (0, 0, 0), (1.0, 0.2, 0.2))
            vdim = 3

            def make(m, asm=asm_mod, BC=BC):
                return (asm.assemble_elasticity_stencil(m, LAM, MU),
                        BC.from_masks([(m.face_mask(0, 0), 0.0)],
                                      m.node_shape, vdim=3))
            b = asm_mod.assemble_vector_load(mesh, np.array([0, 0, -7.65e4]))
        K, bc = make(mesh)
        out.append((mesh, prep(K, mesh, bc, b, vdim), make, vdim))
    return out


@pytest.mark.parametrize("kind", ["scalar", "block"])
def test_solve_mg_matches_reference(kind):
    """``solve_mg`` on a float64 hierarchy of each package: λmax per level
    (so ω) to 1e-12, the same iterations, x̂ within 1e-9.  Every level of
    the port's float64 hierarchy holds plain float64 tensors (no kernel
    operator, no bf16 copy).  Both drop the coarsest dense inverse and run
    the 60-iteration CG coarse solve (ROADMAP queue 3): the port's result
    is bitwise that of ``mg_pcg`` on the hierarchy without ``Ainv``."""
    (mesh, sysm, make, vdim), (rmesh, rsys, rmake, _) = _systems(kind)
    h = mg.build_hierarchy(mesh, sysm, make, vdim=vdim, device="cpu",
                           dtype=torch.float64)
    h_ref = ref_mg.build_hierarchy(rmesh, rsys, rmake, vdim=vdim,
                                   dtype=jnp.float64)
    assert len(h.levels) == len(h_ref.levels) >= 2
    for lv, lv_ref in zip(h.levels, h_ref.levels):
        assert isinstance(lv.weights, tuple) and lv.w_lo is None
        assert all(W.dtype == torch.float64 for W in lv.weights)
        assert lv.free.dtype == torch.float64
        for a in (lv.s, lv.C, lv.Cinv):
            assert a is None or a.dtype == torch.float64
        assert abs(lv.omega - lv_ref.omega) <= 1e-12 * lv_ref.omega
    assert h.levels[-1].Ainv.dtype == torch.float64
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-10, 200)
    xh_ref, k_ref, relres_ref = ref_mg.solve_mg(h_ref, rsys.b_hat, None,
                                                1e-10, 200)
    assert _same_iterations(k, k_ref) and relres <= 1e-10
    assert _gap(xh.numpy(), np.asarray(xh_ref)) <= 1e-9
    no_ainv = h._replace(levels=tuple(lv._replace(Ainv=None)
                                      for lv in h.levels))
    b = torch.as_tensor(sysm.b_hat)
    x2, k2, _ = mg.mg_pcg(no_ainv, b, torch.zeros_like(b), 1e-10, 200)
    assert k2 == k and torch.equal(x2, xh)


# ----------------------------------------------------------------------
# Scans at float64
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tool,kw,cfg", [
    ("solve_heat_3D", dict(nx=6, ny=4, nz=4, num_steps=3), {}),
    ("solve_heat_3D", dict(nx=8, ny=8, nz=8, num_steps=3), DEVICE_PATH),
    ("solve_heat_2D_mixed", dict(nx=8, ny=8, num_steps=4, boundary_conditions={
        "left": {"type": "dirichlet", "value": 100.0, "amplitude": 20.0,
                 "period": 0.1},
        "right": {"type": "robin", "h": 5.0, "T_ambient": 20.0}}), {}),
    ("solve_advection_2D", dict(nx=8, ny=8, num_steps=4), {}),
    ("solve_wave_2D", dict(nx=8, ny=6, num_steps=4), {}),
    ("solve_wave_3D", dict(nx=8, ny=8, nz=8, num_steps=3), DEVICE_PATH),
    ("solve_elasticity_3D_dynamic", dict(nx=4, ny=2, nz=2, num_steps=4,
                                         **BEAM), {}),
    ("solve_elasticity_3D_dynamic", dict(nx=8, ny=4, nz=4, num_steps=3,
                                         **BEAM), DEVICE_PATH),
], ids=["heat CG", "heat MG", "heat mixed driven", "advection cnab2",
        "wave 2D", "wave 3D MG", "dynamic CG", "dynamic MG"])
def test_scan_f64_matches_reference(tool, kw, cfg, tmp_path):
    """Float64 scans under the CPU's default "auto": every step solved to
    ``tol`` by CG on float64 tensors or MG-PCG on a float64 hierarchy;
    the frames within 1e-9 of the JAX package's, the same iterations (a
    θ-scan's: those of the port's per-step path, as its steps stop on their
    free rows and the JAX package's on a norm the Dirichlet values fill)."""
    port, ref = _run(tool, tmp_path, cfg, **kw)
    own = None
    if tool.startswith(("solve_heat", "solve_advection")):
        with config.config_overrides(**cfg), device_loop._per_step():
            own = getattr(api, tool)(
                **kw, data_dir=str(tmp_path / "per_step")).meta[
                    "solver_stats"]["cg_iterations"]
    _hold_f64(port, ref, own)


def test_f64_scan_keeps_float64_frames(monkeypatch):
    """The kept frames of a float64 scan are float64 on the device (the
    reference's ``snap32`` is false at f64); a float32 scan keeps float32
    frames whatever ``snapshot_dtype`` says."""
    seen = []
    orig = timestepping._transient_scan

    def spy(ops, mode, u, u_prev, step0, n, every, snap_dtype):
        seen.append((mode, u.dtype, snap_dtype))
        return orig(ops, mode, u, u_prev, step0, n, every, snap_dtype)

    monkeypatch.setattr(timestepping, "_transient_scan", spy)
    K, M, mesh, bc, b, u0 = _small_heat()
    for prec, snap in (("auto", "f32"), ("f32", "f64"), ("mixed", "f32")):
        with config.config_overrides(precision=prec, snapshot_dtype=snap):
            timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01, 2)
    assert seen == [("f64", torch.float64, torch.float64),
                    ("f32", torch.float32, torch.float32),
                    ("f32", torch.float32, torch.float32)]


def _small_heat():
    mesh = box_mesh(6, 4, 4, (0, 0, 0), (1, 1, 1))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 5.0)], mesh.node_shape)
    u0 = np.asarray(bc.apply_values(np.full(mesh.node_shape, 20.0)))
    return K, M, mesh, bc, assembly.assemble_load(mesh), u0


# ----------------------------------------------------------------------
# No "mixed" transient step
# ----------------------------------------------------------------------

def test_mixed_step_body_is_reached_by_no_run_transient_precision(
        monkeypatch):
    """``run_transient`` maps "mixed" to "f32" at its top, as the reference
    does: its step body only ever runs "f32" or "f64", so the port's body
    has no "mixed" mode and ``transient_refine_rounds`` changes nothing.
    (A step that outruns its step program's budget runs its body again
    step by step, in the same mode.)"""
    modes = []
    orig = timestepping._transient_step_body

    def spy(ops, mode, *a):
        modes.append(mode)
        return orig(ops, mode, *a)

    monkeypatch.setattr(timestepping, "_transient_step_body", spy)
    K, M, mesh, bc, b, u0 = _small_heat()
    seen = []
    for prec in ("mixed", "f32", "f64", "auto"):
        del modes[:]
        with config.config_overrides(precision=prec,
                                     transient_refine_rounds=3):
            timestepping.run_transient(K, M, mesh, bc, b, u0, 0.01, 1)
        seen.append(sorted(set(modes)))
    assert seen == [["f32"], ["f32"], ["f64"], ["f64"]]


# ----------------------------------------------------------------------
# The service layer with PDE_TPU_DEVICE=cpu alone
# ----------------------------------------------------------------------

def test_mcp_server_on_the_cpu_default_matches_reference_f64(tmp_path):
    """The port's MCP server with ``PDE_TPU_DEVICE=cpu`` and no precision
    set ("auto" → float64) serves a static solve above host LU and a heat
    transient within 1e-9 of the JAX package's float64 fields."""
    import json

    calls = [("solve_elasticity_3D_static",
              dict(nx=32, ny=8, nz=8, E=210e9, nu=0.3, **BEAM)),
             ("solve_heat_3D", dict(nx=6, ny=4, nz=4, num_steps=3))]
    lines = [{"jsonrpc": "2.0", "id": i, "method": "tools/call",
              "params": {"name": tool, "arguments": dict(
                  kw, data_dir=str(tmp_path / "port"))}}
             for i, (tool, kw) in enumerate(calls)]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PDE_TPU_") and k != "OPENAI_API_KEY"}
    env["PDE_TPU_DEVICE"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "pde_solver_tpu_torch.mcp.server"],
        input="".join(json.dumps(m) + "\n" for m in lines), cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    replies = [json.loads(line) for line in proc.stdout.splitlines()]
    for (tool, kw), reply in zip(calls, replies):
        assert reply["result"]["isError"] is False, reply
        payload = json.loads(reply["result"]["content"][0]["text"])
        ref = getattr(ref_api, tool)(**kw, data_dir=str(tmp_path / "ref"))
        v = load_field(payload["data_file"]).values_array()
        assert _gap(v, ref_load(ref.data_file).values_array()) <= 1e-9


# ----------------------------------------------------------------------
# tests/test_core_fem.py, the solves
# ----------------------------------------------------------------------

def test_stencil_apply_equals_dense():
    mesh = box_mesh(3, 3, 2, (0, 0, 0), (1, 1, 1))
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    A = assembly.stencil_to_dense(mesh, st)
    x = np.random.default_rng(0).standard_normal(mesh.node_shape)
    offsets = tuple(sorted(st))
    y = linsolve._stencil_apply(offsets, tuple(torch.as_tensor(st[o])
                                               for o in offsets),
                                torch.as_tensor(x), 3, 1).numpy()
    flat = (lambda g: np.moveaxis(g, range(3), range(3)[::-1]).reshape(-1))
    assert np.allclose(flat(y), A @ flat(x), rtol=1e-12, atol=1e-12)


def test_cg_poisson_1d_linear_profile():
    """Steady heat −k u'' = 0, u(0)=20, u(L)=0: the exact linear profile
    from the float64 CG branch."""
    L = 2.0
    mesh = interval_mesh(64, 0.0, L)
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 20.0),
                                 (mesh.face_mask(0, 1), 0.0)], mesh.node_shape)
    with config.config_overrides(host_direct_threshold=0, tol=1e-13):
        x, st_ = linsolve.solve_stencil_system(st, mesh, bc,
                                               np.zeros(mesh.node_shape))
    assert bool(st_.converged)
    assert np.allclose(x, 20.0 * (1.0 - mesh.axis_nodes(0) / L), atol=1e-9)


def test_cg_poisson_3d_vs_dense_solve():
    mesh = box_mesh(4, 3, 3, (0, 0, 0), (1, 1, 1))
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    A = assembly.stencil_to_dense(mesh, st)
    bc = DirichletBC.from_masks([(all_boundary(mesh), 5.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh) * 3.0
    with config.config_overrides(host_direct_threshold=0, tol=1e-13):
        x, _ = linsolve.solve_stencil_system(st, mesh, bc, b)
    flat = (lambda g: np.moveaxis(np.asarray(g), range(3),
                                  range(3)[::-1]).reshape(-1))
    free = flat(bc.free_mask) > 0.5
    g = flat(bc.values) * ~free
    A_mod = A.copy()
    rhs = np.where(free, flat(b) - A @ g, g)
    A_mod[~free, :] = 0.0
    A_mod[:, ~free] = 0.0
    A_mod[~free, ~free] = 1.0
    assert np.allclose(flat(x), np.linalg.solve(A_mod, rhs), atol=1e-9)


def test_mixed_refinement_reaches_f64_accuracy():
    mesh = interval_mesh(200, 0.0, 1.0)
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 1.0),
                                 (mesh.face_mask(0, 1), 0.0)], mesh.node_shape)
    with config.config_overrides(precision="mixed", host_direct_threshold=0,
                                 refine_rounds=4):
        x, st_ = linsolve.solve_stencil_system(st, mesh, bc,
                                               np.zeros(mesh.node_shape))
    assert np.allclose(x, 1.0 - mesh.axis_nodes(0), atol=1e-9)
    assert float(st_.relative_residual) < 1e-10


# ----------------------------------------------------------------------
# tests/test_mixed_precision.py
# ----------------------------------------------------------------------

def test_mixed_heat_steady_matches_analytic():
    mesh = interval_mesh(128, 0.0, 2.0)
    p = heat.HeatProblem(mesh=mesh, steady=True,
                         bc_pairs=[(mesh.face_mask(0, 0), 20.0),
                                   (mesh.face_mask(0, 1), 0.0)])
    with config.config_overrides(precision="mixed"):
        _, values, info = heat.solve_heat_problem(p)
    assert info["converged"]
    exact = 20.0 * (1 - mesh.axis_nodes(0) / 2.0)
    assert np.max(np.abs(values[0] - exact)) < 1e-7


@pytest.mark.parametrize("family", ["elasticity", "transient"])
def test_mixed_matches_f64(family):
    """"mixed" against "f64" in the port: the static cantilever within
    1e-6, the float32 heat transient within 5e-6 (relative L2)."""
    out = {}
    for prec in ("mixed", "f64"):
        with config.config_overrides(precision=prec, host_direct_threshold=0):
            if family == "elasticity":
                mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.2, 0.2))
                out[prec], info = elast.solve_elasticity_nd(
                    mesh, 210e9, 0.3, np.array([0.0, 0.0, -7.65e4]), "3d",
                    "stress")
                assert info["converged"], info
            else:
                mesh = interval_mesh(64, 0.0, 1.0)
                _, out[prec], _ = heat.solve_heat_problem(heat.HeatProblem(
                    mesh=mesh, dt=0.005, num_steps=10, T_initial=20.0,
                    bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                              (mesh.face_mask(0, 1), 0.0)]))
    rel = np.linalg.norm(out["mixed"] - out["f64"]) / np.linalg.norm(
        out["f64"])
    assert rel < (1e-6 if family == "elasticity" else 5e-6), rel


def test_snapshot_thinning_matches_dense_trajectory_f64():
    """Thinned float64 scan: every k-th frame plus the final state,
    matching the dense trajectory at those times."""
    mesh = rectangle_mesh(10, 8, (0.0, 0.0), (1.0, 1.0))

    def make():
        return heat.HeatProblem(
            mesh=mesh, bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
            T_initial=20.0, dt=0.01, num_steps=13)

    t_d, v_d, _ = heat.solve_heat_problem(make(), dataclasses.replace(
        CPU, precision="f64"))
    t_t, v_t, _ = heat.solve_heat_problem(make(), dataclasses.replace(
        CPU, precision="f64", snapshot_max_frames=4))
    assert v_d.shape[0] == 14 and v_t.shape[0] < v_d.shape[0]
    assert t_t[-1] == t_d[-1]
    for tt, vv in zip(t_t, v_t):
        np.testing.assert_allclose(vv, v_d[int(round(tt / 0.01))], rtol=0,
                                   atol=1e-12)


def test_f64_mg_cache_hits_and_stays_correct():
    """Float64 MG solves of one operator with other BC values hit the
    hierarchy cache; another coefficient misses; the float64 and "mixed"
    hierarchies of one operator never share an entry."""
    mesh = box_mesh(8, 8, 8, (0, 0, 0), (1.0, 1.0, 1.0))

    def solve(T_left, diff, prec="f64"):
        cfg = dataclasses.replace(CPU, precision=prec, mg_threshold=100,
                                  host_direct_threshold=0)
        return heat.solve_heat_problem(heat.HeatProblem(
            mesh=mesh, diffusivity=diff, steady=True,
            bc_builder=lambda m: [(m.face_mask(0, 0), T_left),
                                  (m.face_mask(0, 1), 0.0)]), cfg)[1]

    linsolve._MG_CACHE.clear()
    v100 = solve(100.0, 1.0)
    assert len(linsolve._MG_CACHE) == 1
    v50 = solve(50.0, 1.0)
    assert len(linsolve._MG_CACHE) == 1
    np.testing.assert_allclose(v50, 0.5 * v100, rtol=0, atol=1e-9 * 100)
    v_k = solve(100.0, 2.0)
    assert len(linsolve._MG_CACHE) == 2
    np.testing.assert_allclose(v_k, v100, rtol=0, atol=1e-9 * 100)
    v_mixed = solve(100.0, 2.0, "mixed")
    precs = sorted(key[2] for key in linsolve._MG_CACHE.keys())
    assert precs == ["f64", "mixed"]
    assert _gap(v_mixed, v_k) <= 1e-6
    linsolve._MG_CACHE.clear()


def test_transient_mg_step_solves_match_plain_cg():
    mesh = box_mesh(12, 12, 12, (0, 0, 0), (1.0, 1.0, 1.0))

    def make():
        return heat.HeatProblem(
            mesh=mesh, bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
            T_initial=20.0, dt=0.01, num_steps=4)

    cfg_mg = dataclasses.replace(CPU, precision="f32", mg_threshold=100,
                                 transient_mg_threshold=100,
                                 transient_inner_tol=1e-8)
    cfg_cg = dataclasses.replace(CPU, precision="f32", use_multigrid=False,
                                 transient_inner_tol=1e-8)
    _, v_mg, info_mg = heat.solve_heat_problem(make(), cfg_mg)
    _, v_cg, info_cg = heat.solve_heat_problem(make(), cfg_cg)
    assert np.abs(v_mg - v_cg).max() < 1e-5 * np.abs(v_cg).max()
    assert info_mg["cg_iterations"] < 0.5 * info_cg["cg_iterations"]


# ----------------------------------------------------------------------
# tests/test_multigrid.py
# ----------------------------------------------------------------------

def _poisson_hierarchy(cells):
    K, mesh, bc, b, builder = _poisson(cells, value=0.0)
    sysm = linsolve.prepare_system(K, mesh, bc, b, 1)
    return mesh, sysm, mg.build_hierarchy(mesh, sysm, builder, device="cpu",
                                          dtype=torch.float64)


def test_mg_pcg_poisson_converges_fast():
    _, _, h = _poisson_hierarchy((16, 16, 16))
    assert h is not None and len(h.levels) >= 3
    _, k, relres = mg.solve_mg(h, _poisson_hierarchy((16, 16, 16))[1].b_hat,
                               None, 1e-10, 100)
    assert relres < 1e-10 and k <= 20, k


def test_mg_pcg_matches_direct_solution():
    mesh, sysm, h = _poisson_hierarchy((8, 8, 8))
    xh, _, _ = mg.solve_mg(h, sysm.b_hat, None, 1e-12, 200)
    K, _, bc, b, _ = _poisson((8, 8, 8), value=0.0)
    x_ref, _ = linsolve.solve_stencil_system(K, mesh, bc, b)
    assert np.allclose(sysm.from_hat_x(xh.numpy()), x_ref, atol=1e-9)


def test_mg_elasticity_block_scaling():
    mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
    K = assembly.assemble_elasticity_stencil(mesh, 1.21e11, 8.08e10)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = linsolve.prepare_system(K, mesh, bc, b, 3)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, 1.21e11, 8.08e10),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device="cpu",
                           dtype=torch.float64)
    assert h is not None and len(h.levels) >= 3
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-10, 200)
    assert relres < 1e-10 and k <= 70, k
    with config.config_overrides(use_multigrid=False):
        x_ref, _ = linsolve.solve_stencil_system(K, mesh, bc, b, vdim=3)
    x = sysm.from_hat_x(xh.numpy())
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8


def test_solve_facade_uses_mg_for_large_elasticity():
    mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
    with config.config_overrides(mg_threshold=1000):
        _, info = elast.solve_elasticity_nd(
            mesh, 210e9, 0.3, np.array([0, 0, -7.65e4]), "3d", "stress")
    assert info["converged"] and info["cg_iterations"] <= 100


# ----------------------------------------------------------------------
# tests/test_thermal.py, the solves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("clamp_both", [True, False])
def test_bar_thermal_stress(clamp_both):
    """Fully constrained bar heated by ΔT: σ = −EαΔT; fixed-free: σ = 0."""
    E, alpha, dT = 70e9, 2.3e-5, 40.0
    _, sigma, info = elast.solve_bar_1d(2.0, 64, E, 1e-4, 0.0, alpha=alpha,
                                        delta_T=dT, clamp_both=clamp_both)
    assert info["converged"]
    expected = -E * alpha * dT if clamp_both else 0.0
    assert np.abs(sigma - expected).max() <= 1e-9 * E * alpha * dT


def test_bar_clamp_both_end_load_raises():
    with pytest.raises(ValueError, match="end_load"):
        elast.solve_bar_1d(1.0, 16, 70e9, 1e-4, 0.0, end_load=100.0,
                           clamp_both=True)


def _to_grid(flat_field, mesh):
    v = np.asarray(flat_field).reshape(mesh.node_shape[::-1])
    return np.moveaxis(v, range(mesh.dim), range(mesh.dim)[::-1])


def test_clamp_both_nd_thermal_through_mg():
    E, nu, alpha, dT = 210e9, 0.3, 1.2e-5, 50.0
    mesh = rectangle_mesh(64, 8, (0.0, 0.0), (8.0, 1.0))
    with config.config_overrides(mg_threshold=100, host_direct_threshold=0):
        field, info = elast.solve_elasticity_nd(
            mesh, E, nu, np.zeros(2), "plane_strain", thermal=(alpha, dT),
            clamp_both=True)
    assert info["converged"]
    lam, mu = elast.lame_parameters(E, nu, "plane_strain")
    beta = elast.thermal_stress_coefficient(E, nu, alpha, "plane_strain")
    expected = np.sqrt(5.0 / 6.0) * beta * dT * 2.0 * mu / (lam + 2.0 * mu)
    vm = _to_grid(field, mesh)
    center = vm[mesh.node_shape[0] // 2, mesh.node_shape[1] // 2]
    assert abs(center - expected) < 0.05 * expected


def test_thermal_3d_solve_iso_consistency():
    mesh = box_mesh(8, 6, 6, (0, 0, 0), (1.0, 0.6, 0.6))
    E, nu, alpha, dT = 210e9, 0.3, 1.2e-5, 30.0
    field, info = elast.solve_elasticity_nd(mesh, E, nu, np.zeros(3), "3d",
                                            thermal=(alpha, dT))
    assert info["converged"]
    beta = elast.thermal_stress_coefficient(E, nu, alpha, "3d")
    vm = _to_grid(field, mesh)
    assert vm[-1, 1:-1, 1:-1].max() < 0.05 * beta * dT
    assert vm[0].max() > 0.3 * beta * dT


# ----------------------------------------------------------------------
# tests/test_models.py, the closed forms and the scipy parity cases
# ----------------------------------------------------------------------

rel_l2 = ref_tm.rel_l2


@pytest.mark.parametrize("weight,lo,hi,tol", [
    (None, 0.0, 2.0, None),
    ("cyl", 0.5, 2.0, 2e-6),
    ("sph", 0.5, 2.0, 5e-6),
])
def test_heat_1d_steady_profiles(weight, lo, hi, tol):
    """Linear (Cartesian), log r (cylindrical), 1/r (spherical)."""
    n = 256 if weight is None else 400
    mesh = interval_mesh(n, lo, hi)
    wf, deg = {None: (None, 4), "cyl": (heat.weight_r, 3),
               "sph": (heat.weight_r2, 4)}[weight]
    T0, T1 = (20.0, 0.0) if weight is None else (100.0, 20.0)
    p = heat.HeatProblem(mesh=mesh, steady=True, weight_fn=wf,
                         weight_quad_degree=deg,
                         bc_pairs=[(mesh.face_mask(0, 0), T0),
                                   (mesh.face_mask(0, 1), T1)])
    _, values, info = heat.solve_heat_problem(p)
    r = mesh.axis_nodes(0)
    if weight is None:
        assert info["converged"]
        assert np.max(np.abs(values[0] - 20.0 * (1 - r / 2.0))) < 1e-8
        return
    if weight == "cyl":
        shape = np.log(r / lo) / np.log(hi / lo)
    else:
        shape = (1 / lo - 1 / r) / (1 / lo - 1 / hi)
    assert rel_l2(values[0], T0 + (T1 - T0) * shape) < tol


def _flat_mask(mesh, pairs):
    from pde_solver_tpu_torch.mesh import flatten_values
    m = np.zeros(mesh.node_shape, dtype=bool)
    v = np.zeros(mesh.node_shape)
    for mask, val in pairs:
        m |= mask
        v = np.where(mask, val, v)
    return flatten_values(m, mesh.dim), flatten_values(v, mesh.dim)


@pytest.mark.parametrize("steady", [True, False],
                         ids=["steady", "transient"])
def test_heat_2d_parity_vs_scipy(steady):
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    pairs = [(mesh.boundary_mask(), 0.0)]
    p = heat.HeatProblem(mesh=mesh, diffusivity=0.7, steady=steady,
                         bc_pairs=pairs, source_type="constant",
                         source_value=5.0, T_initial=20.0, dt=0.01,
                         num_steps=10)
    times, values, _ = heat.solve_heat_problem(p)
    fm, fv = _flat_mask(mesh, pairs)
    golden = ref_tm.scipy_heat(mesh, None, 0.7, fm, fv, 5.0, steady,
                               u0_flat=np.where(fm, fv, 20.0), dt=0.01,
                               num_steps=10)
    if steady:
        assert rel_l2(values[0], golden) < 1e-9
    else:
        assert values.shape == (11, mesh.num_nodes)
        assert rel_l2(values, golden) < 1e-9
        assert np.allclose(times, 0.01 * np.arange(11))


def test_heat_2d_spherical_parity_vs_scipy():
    mesh = rectangle_mesh(10, 8, (0.2, 0.0), (1.0, np.pi))
    pairs = [(mesh.boundary_mask(), 20.0)]
    p = heat.HeatProblem(mesh=mesh, steady=False,
                         weight_fn=heat.weight_r2_sin_theta,
                         weight_quad_degree=6, bc_pairs=pairs,
                         source_type="constant", source_value=30.0,
                         T_initial=50.0, curvilinear_ic=True, dt=0.02,
                         num_steps=5)
    _, values, _ = heat.solve_heat_problem(p)
    fm, fv = _flat_mask(mesh, pairs)
    golden = ref_tm.scipy_heat(
        mesh, lambda x: x[..., 0] ** 2 * np.sin(x[..., 1]), 1.0, fm, fv,
        30.0, False, u0_flat=np.where(fm, fv, 50.0), dt=0.02, num_steps=5,
        degree=6)
    assert rel_l2(values, golden) < 1e-9


@pytest.mark.parametrize("weight_kind,tol", [("poly", 1e-9),
                                             ("sqrt_r", 2e-5)])
def test_heat_3d_composite_directional_parity_vs_scipy(weight_kind, tol):
    from pde_solver_tpu_torch.ops.bc import radius_shell

    R = 0.5
    mesh = box_mesh(6, 5, 5, (0.0, -R, -R), (2.0, R, R))
    kappa_cells = heat.composite_kappa_cells(mesh, 0.25, 1.0, 10.0)
    pairs = [(mesh.face_mask(0, 0), 80.0), (mesh.face_mask(0, 1), 10.0),
             (radius_shell(mesh, (1, 2), R, exclude_axis_faces=0), 20.0)]
    if weight_kind == "poly":
        def w(x):
            return x[..., 1] ** 2 + x[..., 2] ** 2 + 0.1
    else:
        def w(x):
            return np.sqrt(x[..., 1] ** 2 + x[..., 2] ** 2)
    p = heat.HeatProblem(mesh=mesh, steady=True, weight_fn=w,
                         weight_quad_degree=4, kappa_cells=kappa_cells,
                         bc_pairs=pairs, source_type="constant",
                         source_value=3.0)
    _, values, _ = heat.solve_heat_problem(p)
    fm, fv = _flat_mask(mesh, pairs)
    cc = np.moveaxis(kappa_cells, 0, -1).reshape(-1)
    golden = ref_tm.scipy_heat(mesh, w, None, fm, fv, 3.0, True,
                               cell_coeff=cc, degree=4)
    assert rel_l2(values[0], golden) < tol


def test_heat_ic_projection_cosine_matches_scipy_projection():
    mesh = interval_mesh(40, 0.0, 2.0)
    p = heat.HeatProblem(mesh=mesh, bc_pairs=[(mesh.face_mask(0, 0), 1.0),
                                              (mesh.face_mask(0, 1), 0.0)],
                         initial_type="cosine", initial_amplitude=2.0,
                         initial_wavenumber=3.0, dt=0.01, num_steps=1)
    _, values, _ = heat.solve_heat_problem(p)
    verts, cells = ref_fem.build_simplices(mesh.n_cells, mesh.origin,
                                           mesh.extent)
    M = ref_fem.assemble(verts, cells, "mass", degree=2)
    b = ref_fem.assemble_load(verts, cells,
                              f=lambda x: 2.0 * np.cos(3.0 * x[..., 0]),
                              degree=4)
    pgold = spla.spsolve(M.tocsr(), b)
    pgold[0], pgold[-1] = 1.0, 0.0
    assert rel_l2(values[0], pgold) < 1e-8


def test_crank_nicolson_second_order_decay():
    errs = []
    for num_steps in (10, 20):
        mesh = interval_mesh(200, 0.0, 1.0)
        p = heat.HeatProblem(mesh=mesh, theta=0.5,
                             bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                                       (mesh.face_mask(0, 1), 0.0)],
                             initial_type="sine", initial_amplitude=1.0,
                             initial_wavenumber=np.pi, dt=0.1 / num_steps,
                             num_steps=num_steps)
        _, values, _ = heat.solve_heat_problem(p)
        x = mesh.axis_nodes(0)
        exact = np.sin(np.pi * x) * np.exp(-np.pi ** 2 * 0.1)
        errs.append(np.max(np.abs(values[-1] - exact)))
    assert errs[1] < errs[0] / 2.5


@pytest.mark.parametrize("quantity", ["stress", "strain"])
def test_bar_1d_analytic(quantity):
    if quantity == "stress":
        L, nx, E, A, f = 2.0, 100, 70e9, 0.01, 500.0
        x, v, info = elast.solve_bar_1d(L, nx, E, A, f, "stress")
        exact = f * (L - x) / A
        assert np.abs(v[1] - exact[1]) < 0.1 * np.max(np.abs(exact))
        assert info["converged"]
    else:
        L, nx, E, A, f = 1.0, 50, 210e9, 1.0, 1000.0
        x, v, _ = elast.solve_bar_1d(L, nx, E, A, f, "strain")
        exact = f * (L - x) / (E * A)
    assert np.max(np.abs(v[8:-8] - exact[8:-8])) < \
        1e-6 * np.max(np.abs(exact))


@pytest.mark.parametrize("mode,cells", [("plane_stress", (8, 6)),
                                        ("plane_strain", (8, 6)),
                                        ("3d", (4, 3, 3))])
def test_elasticity_parity_vs_scipy(mode, cells):
    """Vector solve and von Mises projection against a dense scipy golden
    path (the JAX package's own ``test_models.py`` construction)."""
    import math

    d = len(cells)
    mesh = (rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0)) if d == 2 else
            box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2)))
    body = np.array([0.0, -7.65e4] if d == 2 else [0.0, 0.0, -7.65e4])
    vm, _ = elast.solve_elasticity_nd(mesh, 210e9, 0.3, body, mode, "stress")
    lam, mu = elast.lame_parameters(210e9, 0.3, mode)
    verts, cells_ = ref_fem.build_simplices(mesh.n_cells, mesh.origin,
                                            mesh.extent)
    Kel = ref_fem.assemble_elasticity(verts, cells_, lam, mu).tolil()
    N = len(verts)
    b = np.zeros(N * d)
    bload = ref_fem.assemble_load(verts, cells_, degree=1)
    for i in range(d):
        b[i::d] = bload * body[i]
    clamped = np.repeat(np.isclose(verts[:, 0], 0.0), d)
    b = np.where(clamped, 0.0, b)
    Kel[clamped, :] = 0.0
    Kel[:, clamped] = 0.0
    Kel[clamped, clamped] = 1.0
    u = spla.spsolve(Kel.tocsr(), b)
    Mmat = ref_fem.assemble(verts, cells_, "mass", degree=2)
    rhs = np.zeros(N)
    for cell in cells_:
        X = verts[cell]
        J = (X[1:] - X[0]).T
        grads = np.vstack([-np.ones((1, d)), np.eye(d)]) @ np.linalg.inv(J)
        G = sum(np.outer(u[cell[a] * d: cell[a] * d + d], grads[a])
                for a in range(d + 1))
        eps = 0.5 * (G + G.T)
        sig = lam * np.trace(eps) * np.eye(d) + 2 * mu * eps
        sdev = sig - np.trace(sig) / 3.0 * np.eye(d)
        vol = abs(np.linalg.det(J)) / math.factorial(d)
        rhs[cell] += np.sqrt(1.5 * np.sum(sdev * sdev)) * vol / (d + 1)
    vm_gold = spla.spsolve(Mmat.tocsr(), rhs)
    assert rel_l2(vm, vm_gold) < (1e-8 if d == 2 else 1e-7)


def test_composite_core_multigrid_matches_plain_cg():
    mesh = box_mesh(16, 16, 16, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

    def kb(m):
        return heat.composite_kappa_cells(m, 0.3, 1.0, 50.0,
                                          radial_axes=(1, 2))

    def make(use_mg):
        return heat.HeatProblem(
            mesh=mesh, kappa_builder=kb if use_mg else None,
            kappa_cells=None if use_mg else kb(mesh),
            bc_builder=lambda m: [(m.face_mask(0, 0), 100.0),
                                  (m.face_mask(0, 1), 0.0)],
            steady=True)

    _, v_mg, info_mg = heat.solve_heat_problem(make(True), dataclasses.replace(
        CPU, precision="f64", mg_threshold=100))
    _, v_cg, info_cg = heat.solve_heat_problem(make(False), dataclasses.replace(
        CPU, precision="f64", use_multigrid=False))
    assert info_mg["converged"] and info_cg["converged"]
    assert np.abs(v_mg - v_cg).max() < 1e-7 * np.abs(v_cg).max()
    assert info_mg["cg_iterations"] < info_cg["cg_iterations"]


def test_transient_info_timing_contract():
    mesh = rectangle_mesh(8, 8, (0.0, 0.0), (1.0, 1.0))
    p = heat.HeatProblem(mesh=mesh, bc_pairs=[(mesh.boundary_mask(), 0.0)],
                         T_initial=20.0, dt=0.01, num_steps=4)
    _, values, info = heat.solve_heat_problem(p)
    assert values.shape[0] == 5
    for key in ("scan_seconds", "setup_seconds", "fetch_seconds"):
        assert info[key] >= 0.0


# ----------------------------------------------------------------------
# tests/test_traction.py and tests/test_elasticity.py
# ----------------------------------------------------------------------

def test_bar_end_load_exact_stress(tmp_path):
    P, A = 5000.0, 0.01
    f = load_field(api.solve_elasticity_1D_loaded(
        L=2.0, nx=40, E=200e9, area=A, end_load=P,
        data_dir=str(tmp_path)).data_file)
    np.testing.assert_allclose(f.values_array()[0], P / A, rtol=1e-8)
    assert f.meta["end_load"] == P


def test_bar_end_load_plus_body_force(tmp_path):
    P, A, L, fb = 1000.0, 0.02, 1.5, 300.0
    f = load_field(api.solve_elasticity_1D_loaded(
        L=L, nx=32, E=70e9, area=A, end_load=P, body_force=fb,
        data_dir=str(tmp_path)).data_file)
    x = f.coords_array()[:, 0]
    exact = (P + fb * (L - x)) / A
    v = f.values_array()[0]
    np.testing.assert_allclose(v[1:-1], exact[1:-1], rtol=2e-3)
    mid = slice(len(x) // 3, 2 * len(x) // 3)
    np.testing.assert_allclose(v[mid], exact[mid], rtol=1e-8)


@pytest.mark.parametrize("case", ["traction 2D", "traction 3D", "force 3D",
                                  "pressure 2D"])
def test_uniform_surface_load_von_mises(case, tmp_path):
    """ν = 0 uniform states: von Mises is the load, ×√(5/6) under the 2D
    formula."""
    if case == "traction 2D":
        t = 2.5e6
        r = api.solve_elasticity_2D_loaded(
            Lx=2.0, Ly=0.5, nx=16, ny=8, E=100e9, nu=0.0,
            loads={"right": {"type": "traction", "vector": [t, 0.0]}},
            data_dir=str(tmp_path))
        expect = t * np.sqrt(5.0 / 6.0)
    elif case == "traction 3D":
        t = 2.5e6
        r = api.solve_elasticity_3D_loaded(
            Lx=2.0, Ly=0.4, Lz=0.4, nx=10, ny=5, nz=5, E=100e9, nu=0.0,
            loads={"right": {"type": "traction", "vector": [t, 0.0, 0.0]}},
            data_dir=str(tmp_path))
        expect = t
    elif case == "force 3D":
        F = 1.0e5
        r = api.solve_elasticity_3D_loaded(
            Lx=1.0, Ly=0.5, Lz=0.4, nx=8, ny=4, nz=4, E=50e9, nu=0.0,
            loads={"right": {"type": "force", "vector": [F, 0.0, 0.0]}},
            data_dir=str(tmp_path))
        expect = F / (0.5 * 0.4)
    else:
        p = 3.0e5
        r = api.solve_elasticity_2D_loaded(
            Lx=1.0, Ly=0.3, nx=10, ny=4, E=10e9, nu=0.0,
            loads={"right": {"type": "pressure", "value": p}},
            data_dir=str(tmp_path))
        expect = p * np.sqrt(5.0 / 6.0)
    np.testing.assert_allclose(load_field(r.data_file).values_array()[0],
                               expect, rtol=1e-5)


def test_bending_load_sanity(tmp_path):
    f = load_field(api.solve_elasticity_2D_loaded(
        Lx=2.0, Ly=0.2, nx=40, ny=6, E=200e9, nu=0.3,
        loads={"right": {"type": "force", "vector": [0.0, -1000.0]}},
        data_dir=str(tmp_path)).data_file)
    vm, x = f.values_array()[0], f.coords_array()[:, 0]
    assert vm[x < 0.3].max() > 3.0 * vm[x > 1.7].max()
    assert np.all(np.isfinite(vm)) and vm.max() > 0


def test_displacement_quantity_1d_exact(tmp_path):
    f = load_field(api.solve_elasticity_1D_loaded(
        L=1.0, nx=50, E=210e9, area=1e-4, end_load=10e3,
        quantity="displacement", data_dir=str(tmp_path)).data_file)
    exact = 10e3 * 1.0 / (210e9 * 1e-4)
    assert abs(f.values_array()[-1][-1] - exact) / exact < 1e-10
    assert f.meta["name"] == "axial_displacement" and f.meta["unit"] == "m"


def test_displacement_quantity_2d_udl_beam_theory(tmp_path):
    w, Lx, Ly = 2000.0, 3.0, 0.3
    f = load_field(api.solve_elasticity_2D_static(
        Lx=Lx, Ly=Ly, nx=60, ny=8, E=210e9, nu=0.3, body_fy=-w / Ly,
        quantity="displacement", data_dir=str(tmp_path)).data_file)
    eb = w * Lx ** 4 / (8 * 210e9 * (Ly ** 3 / 12.0))
    assert abs(float(f.values_array()[-1].max()) - eb) / eb < 0.15
    assert f.meta["name"] == "displacement_magnitude"


# ----------------------------------------------------------------------
# tests/test_convergence.py
# ----------------------------------------------------------------------

def test_forced_nonconvergence_is_reported():
    K, mesh, bc, b, _ = _poisson((8, 8, 8), value=0.0)
    with config.config_overrides(maxiter=1, host_direct_threshold=0):
        _, stats = linsolve.solve_stencil_system(K, mesh, bc, b)
    assert bool(stats.converged) is False
    assert stats.target > 0 and float(stats.relative_residual) > stats.target


def test_converged_solve_reports_target():
    K, mesh, bc, b, _ = _poisson((8, 8, 8), value=0.0)
    with config.config_overrides(host_direct_threshold=0) as cfg:
        _, stats = linsolve.solve_stencil_system(K, mesh, bc, b)
    assert bool(stats.converged) is True
    assert stats.target == max(cfg.tol, cfg.accuracy_target)
    assert float(stats.relative_residual) <= stats.target


@pytest.mark.parametrize("converged", [False, True])
def test_summary_warns_on_nonconvergence_only(converged):
    from pde_solver_tpu_torch.agents.dispatcher_agent import DispatcherAgent
    from pde_solver_tpu_torch.schema import PDEParameters

    s = DispatcherAgent._generate_summary(
        PDEParameters(pde_type="heat", dim=2),
        {"data_file": "data/x.pkl", "dim": 2, "meta": {"solver_stats": {
            "converged": converged, "relative_residual": 3.2e-3,
            "convergence_target": 1e-6, "cg_iterations": 1}}},
        {"html_path": "plots/x.html"})
    assert ("WARNING" in s) == (not converged)
    if not converged:
        assert "did NOT reach" in s and "3.2" in s


# ----------------------------------------------------------------------
# chip_smoke.precision_phase, rehearsed on the CPU
# ----------------------------------------------------------------------

def test_chip_smoke_precision_phase_rehearsal(tmp_path):
    """``chip_smoke.precision_phase`` at small sizes on the CPU (no launch
    is counted here): every check of the phase holds."""
    import time

    import chip_smoke as cs
    from pde_solver_tpu_torch.ops import stencil_kernels as sk

    d = str(tmp_path)
    flag = dict(cs.FLAGSHIP, nx=8, ny=4, nz=4)
    heat3 = dict(nx=6, ny=6, nz=6, num_steps=3)
    beam = dict(cs.DYNAMIC_3D, nx=8, ny=4, nz=4, num_steps=3)

    def counted(label, fn):
        sk.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        return res, dict(sk.KERNEL_LAUNCHES), time.perf_counter() - t

    with config.config_overrides(host_direct_threshold=0, mg_threshold=100,
                                 transient_mg_threshold=100):
        vm_calls, unspy = cs.spy_von_mises()
        try:
            with config.config_overrides(precision="mixed"):
                vm_mixed = cs.field(api.solve_elasticity_3D_static(
                    **flag, data_dir=d))[0]
        finally:
            unspy()
        (vm_call,) = vm_calls
        with config.config_overrides(precision="f32"):
            T_f32 = cs.field(api.solve_heat_3D(**heat3, data_dir=d))[0]
            calls = cs.spy_newmark()
            api.solve_elasticity_3D_dynamic(**beam, data_dir=d)
            (K, M, _, _, f, *_), _, nres = calls[-1]
            share32 = cs.energy_share(K, M, f, nres)
        m = box_mesh(*cs.SMALL_HEAT_CELLS, (0.0, 0.0, 0.0), (1.0, 0.2, 0.2))
        T_small = cs.theta_scheme_f64(m, [(m.boundary_mask(), 0.0)], 0.01,
                                      cs.SMALL_HEAT["num_steps"])
        out = cs.precision_phase(
            api, counted, d, vm_mixed, vm_call, T_f32, T_small, share32,
            flagship=flag, heat=heat3, beam=beam,
            ckpt_beam=dict(beam, nx=4, ny=2, nz=2, num_steps=6),
            device="cpu", relres_tol=cs.FLOOR_RELRES_TOL)
    assert out["flagship_f64"]["converged"]
    assert out["flagship_f64"]["host_vm_gap"] <= 1e-6
    assert out["dynamic_f64"]["share"] < 1e-6 * share32
    assert out["checkpoint"] and out["smoother_gap"] <= 1e-6
