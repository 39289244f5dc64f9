"""The Newmark (wave 1D/2D/3D, 3D elastodynamics) and modal tool families
of the port against the JAX package at small sizes: signatures, meta,
coordinates, times and values of all six tools; ``run_newmark`` and
``smallest_modes`` of both packages on the same numpy operands; the closed
forms of the JAX package's own tests (``test_wave.py``, ``test_dynamics.py``,
``test_eigen.py``) against the port alone; the in-memory multigrid cache;
and the options that stay unported.

The port's Newmark scan is float32 (``precision="f32"`` or "mixed"), where
the JAX package's own tests run theirs at float64: the bounds that float32
cannot meet are restated here, each with the float64 bound it replaces and
the value measured on the CPU."""

import inspect

import numpy as np
import pytest

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu.models import elasticity as ref_elast
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import eigen as ref_eigen
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch import api
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.mesh import (box_mesh, flatten_values,
                                       interval_mesh, rectangle_mesh)
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models.wave import WaveProblem, solve_wave_problem
from pde_solver_tpu_torch.ops import assembly, eigen, linsolve
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC

TOOLS = ("solve_wave_1D", "solve_wave_2D", "solve_wave_3D",
         "solve_elasticity_3D_dynamic", "solve_elasticity_2D_modal",
         "solve_elasticity_3D_modal")
TRANSIENT = dict(precision="f32", transient_inner_tol=1e-8)
MG = dict(mg_threshold=100, transient_mg_threshold=100)
MIXED = dict(precision="mixed", host_direct_threshold=0)
# the closed-form runs of the port: float32 scan, steps solved to 1e-7
F32 = config.SolverConfig(device="cpu", precision="f32",
                          transient_inner_tol=1e-7)
BEAM = dict(Lx=1.0, Ly=0.2, Lz=0.2, body_fz=-7.65e4)
NEWMARK_TOOLS = {
    "solve_wave_1D": dict(nx=24, num_steps=10),
    "solve_wave_2D": dict(nx=8, ny=6, num_steps=10, wave_speed=2.0,
                          initial_type="cosine", boundary_value=0.5),
    "solve_wave_3D": dict(nx=6, ny=5, nz=4, num_steps=8, source_value=1.0),
}


def _run(tool, tmp_path, cfg, ref_cfg=None, **kw):
    """One tool through both packages; returns (port, reference) as
    (values, times, coords, meta)."""
    out = []
    for pkg, conf, load, c in (
            (api, config, load_field, dict(cfg, device="cpu")),
            (ref_api, ref_config, ref_load, cfg if ref_cfg is None
             else ref_cfg)):
        with conf.config_overrides(**c):
            r = getattr(pkg, tool)(**kw, data_dir=str(tmp_path / pkg.__name__))
        f = load(r.data_file)
        out.append((f.values_array(), f.times_array(), f.coords_array(),
                    r.meta))
    return out


def _gap(v, v_ref):
    return np.abs(v - v_ref).max() / np.abs(v_ref).max()


def _check(port, ref, tol, skip=("solver_stats",)):
    (v, t, c, meta), (v_ref, t_ref, c_ref, meta_ref) = port, ref
    assert {k: x for k, x in meta.items() if k not in skip} == \
        {k: x for k, x in meta_ref.items() if k not in skip}
    assert set(meta) == set(meta_ref)
    assert set(meta["solver_stats"]) == set(meta_ref["solver_stats"])
    assert meta["solver_stats"]["converged"], meta["solver_stats"]
    assert np.array_equal(c, c_ref)
    assert v.shape == v_ref.shape and t.shape == t_ref.shape
    assert np.all(np.isfinite(v))
    assert _gap(v, v_ref) <= tol, _gap(v, v_ref)


@pytest.fixture
def builds(monkeypatch):
    """The node shapes of the fine meshes ``mg.build_hierarchy`` was called
    for, with the cache emptied before and after."""
    linsolve._MG_CACHE.clear()
    calls = []
    orig = mg.build_hierarchy

    def spy(mesh, *a, **kw):
        calls.append(mesh.node_shape)
        return orig(mesh, *a, **kw)

    monkeypatch.setattr(mg, "build_hierarchy", spy)
    yield calls
    linsolve._MG_CACHE.clear()


@pytest.mark.parametrize("tool", TOOLS)
def test_signature_matches_reference(tool):
    assert inspect.signature(getattr(api, tool)) == \
        inspect.signature(getattr(ref_api, tool))


# ----------------------------------------------------------------------
# The six tools through both packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tool", sorted(NEWMARK_TOOLS))
def test_wave_tools_match_reference(tool, tmp_path):
    port, ref = _run(tool, tmp_path, TRANSIENT, **NEWMARK_TOOLS[tool])
    assert np.array_equal(port[1], ref[1])
    # two float32 scans, every step solved to 1e-8: measured 6e-8 – 2e-7
    _check(port, ref, 1e-6)


def test_wave_3d_mg_step_solves_match_reference(tmp_path):
    port, ref = _run("solve_wave_3D", tmp_path, dict(TRANSIENT, **MG),
                     nx=8, ny=8, nz=8, num_steps=6)
    _check(port, ref, 1e-6)
    # MG-PCG in both: the same iterations (measured 21 and 21)
    its = [m["solver_stats"]["cg_iterations"] for *_, m in (port, ref)]
    assert abs(its[0] - its[1]) <= 2 and its[0] < 60, its


@pytest.mark.parametrize("case,cfg,kw,tol", [
    # the right side f − K ũ is a difference of large terms at E = 210 GPa:
    # the two float32 scans lie 2.0e-6 (flat CG) and 7.0e-6 (MG-PCG) apart,
    # and the reference's own float32 scan 8.7e-6 and 1.8e-5 from its
    # float64 one.  At Δt = 1e-5 the mass dominates and 1e-6 holds (2e-7).
    ("flat CG", TRANSIENT, dict(BEAM, nx=8, ny=2, nz=2, num_steps=8), 1e-5),
    ("MG-PCG", dict(TRANSIENT, **MG),
     dict(BEAM, nx=8, ny=4, nz=4, num_steps=6), 2e-5),
    ("mass-dominated", TRANSIENT,
     dict(nx=4, ny=4, nz=4, body_fz=-7.65e4, dt=1e-5, num_steps=8), 1e-6),
])
def test_dynamic_tool_matches_reference(case, cfg, kw, tol, tmp_path):
    port, ref = _run("solve_elasticity_3D_dynamic", tmp_path, cfg, **kw)
    assert np.array_equal(port[1], ref[1])
    _check(port, ref, tol)
    # and the port is as close to the float64 scan as the reference's own
    # float32 scan is
    _, ref64 = _run("solve_elasticity_3D_dynamic", tmp_path, cfg,
                    ref_cfg=dict(cfg, precision="f64"), **kw)
    assert _gap(port[0], ref64[0]) <= 1.5 * _gap(ref[0], ref64[0]) + 1e-6


def _check_modal(port, ref, freq_tol, shape_tol):
    """Frequencies (the frame "times" and ``meta.frequencies_hz``) within
    ``freq_tol`` relative; mode shapes as normalised magnitudes."""
    _check(port, ref, shape_tol, skip=("solver_stats", "frequencies_hz"))
    f, f_ref = (np.asarray(m["frequencies_hz"]) for *_, m in (port, ref))
    assert np.abs(f - f_ref).max() <= freq_tol * f_ref.max()
    assert np.allclose(port[1], f, rtol=1e-15)


@pytest.mark.parametrize("tool,kw", [
    ("solve_elasticity_2D_modal", dict(nx=12, ny=4, num_modes=3)),
    ("solve_elasticity_2D_modal", dict(nx=10, ny=4, num_modes=2,
                                       plane_stress=False)),
    ("solve_elasticity_3D_modal", dict(nx=8, ny=2, nz=2, num_modes=2)),
])
def test_modal_tools_host_lu_match_reference(tool, kw, tmp_path):
    # every solve by host sparse LU in float64, and the block arithmetic is
    # the same numpy: measured bit-equal
    _check_modal(*_run(tool, tmp_path, {}, **kw), 1e-9, 1e-9)


@pytest.mark.parametrize("tool,cfg,kw,built", [
    # flat f32 CG with float64 refinement on the host
    ("solve_elasticity_2D_modal", MIXED, dict(nx=12, ny=4, num_modes=2), []),
    # MG + the double-float32 F-cycle: 3 block vectors × 7 iterations of
    # solves on one operator build one hierarchy, then hit the cache
    ("solve_elasticity_3D_modal", dict(MIXED, mg_threshold=100),
     dict(nx=8, ny=4, nz=4, num_modes=1), [(9, 5, 5)]),
])
def test_modal_tools_device_path_match_reference(tool, cfg, kw, built, builds,
                                                 tmp_path):
    # every solve to relres ≤ 1e-9 and Ritz values are quadratic in the
    # vector error: frequencies measured 5e-14 – 3e-13 apart, shapes 5e-13
    port, ref = _run(tool, tmp_path, cfg, **kw)
    _check_modal(port, ref, 1e-6, 1e-6)
    assert port[3]["solver_stats"]["iterations"] >= 2
    assert builds == built


def test_square_membrane_modal_pair_is_compared_as_a_subspace():
    """A (nearly) degenerate pair (λ = 5π² twice on the unit square) may
    come back rotated: compare the M-orthogonal projector onto the pair,
    not the vectors."""
    ops = {}
    for name, asm, BC, msh, eig in (
            ("port", assembly, DirichletBC,
             rectangle_mesh(12, 12, (0, 0), (1.0, 1.0)), eigen),
            ("ref", ref_asm, RefBC,
             ref_mesh.rectangle_mesh(12, 12, (0, 0), (1.0, 1.0)), ref_eigen)):
        K = asm.assemble_scalar_stencil(msh, "stiffness")
        M = asm.assemble_scalar_stencil(msh, "mass")
        bc = BC.from_masks([(msh.boundary_mask(), 0.0)], msh.node_shape)
        with (config if name == "port" else ref_config).config_overrides(
                **({"device": "cpu"} if name == "port" else {})):
            lams, modes, info = eig.smallest_modes(K, M, msh, bc, num_modes=4)
        assert info["converged"]
        Md = asm.stencil_to_dense(msh, M)
        V = np.stack([flatten_values(m, 2) for m in modes[1:3]], axis=1)
        ops[name] = (lams, V @ V.T @ Md)       # M-orthogonal projector
    assert np.abs(ops["port"][0] - ops["ref"][0]).max() \
        <= 1e-9 * ops["ref"][0].max()
    lams = ops["port"][0]
    # (1,2) and (2,1): 5π² twice in the continuum, 1.7 % apart on this
    # triangulation, which is not symmetric under x ↔ y
    assert abs(lams[1] - lams[2]) <= 0.02 * lams[1]
    assert np.abs(ops["port"][1] - ops["ref"][1]).max() <= 1e-7


# ----------------------------------------------------------------------
# run_newmark and smallest_modes on the same numpy operands
# ----------------------------------------------------------------------

def _newmark_operands(vdim):
    """(K, M, mesh pair, free mask, values, f, u0, v0, dt, coarse-level functions)
    as numpy, from the reference's assembly (the port's is bit-equal)."""
    if vdim == 1:
        cells, ext = (8, 8, 8), (1.0, 1.0, 1.0)
    elif vdim == 2:
        cells, ext = (8, 8), (1.2, 1.0)
    else:
        cells, ext = (8, 4, 4), (1.0, 0.25, 0.25)
    d = len(cells)
    r_mesh = ref_mesh.StructuredMesh(cells, (0.0,) * d, ext)
    p_mesh = box_mesh(*cells, (0, 0, 0), ext) if d == 3 \
        else rectangle_mesh(*cells, (0, 0), ext)
    rng = np.random.default_rng(3)

    def operators(asm, elas, msh, BC):
        if vdim == 1:
            K = {o: 4.0 * W for o, W in
                 asm.assemble_scalar_stencil(msh, "stiffness").items()}
            M = asm.assemble_scalar_stencil(msh, "mass")
            bc = BC.from_masks([(msh.boundary_mask(), 0.0)], msh.node_shape)
        else:
            lam, mu = elas.lame_parameters(1e6, 0.3, "plane_stress"
                                           if vdim == 2 else "3d")
            K = asm.assemble_elasticity_stencil(msh, lam, mu)
            M = elas.assemble_vector_mass(msh, 10.0)
            bc = BC.from_masks([(msh.face_mask(0, 0), 0.0)], msh.node_shape,
                               vdim=vdim)
        return K, M, bc

    K, M, bc = operators(ref_asm, ref_elast, r_mesh, RefBC)
    free = np.asarray(bc.free_mask, np.float64)
    # smooth fields with seeded amplitudes (a rough u0 makes K u0, and with
    # it every float32 right side, a difference of huge terms)
    x = r_mesh.node_coords
    amp = rng.uniform(0.5, 1.5, size=(3, vdim) if vdim > 1 else 3)
    bump = np.prod(np.sin(np.pi * x / np.asarray(ext)), axis=-1)
    ramp = np.sin(0.5 * np.pi * x[..., 0] / ext[0])
    base = bump if vdim == 1 else ramp
    field = base if vdim == 1 else base[..., None] * np.ones(vdim)
    f = free * field * amp[0] * (1.0 if vdim == 1 else 50.0)
    u0 = free * field * amp[1] * 1e-3
    v0 = free * field * amp[2] * 1e-2
    return dict(
        K=K, M=M, f=f, u0=u0, v0=v0, dt=2e-4, vdim=vdim,
        ref=(r_mesh, bc, lambda m: operators(ref_asm, ref_elast, m, RefBC)),
        port=(p_mesh, DirichletBC(free, np.asarray(bc.values, np.float64)),
              lambda m: operators(assembly, elast, m, DirichletBC)))


@pytest.mark.parametrize("solver", ["flat CG", "MG-PCG"])
@pytest.mark.parametrize("vdim", [1, 2, 3])
def test_run_newmark_matches_reference_on_the_same_operands(vdim, solver):
    o = _newmark_operands(vdim)
    cfg = dict(TRANSIENT, **(MG if solver == "MG-PCG" else {}))
    out = {}
    for name, run, conf, extra in (
            ("port", timestepping.run_newmark, config, {"device": "cpu"}),
            ("ref", ref_ts.run_newmark, ref_config, {}),
            ("ref64", ref_ts.run_newmark, ref_config, {"precision": "f64"})):
        msh, bc, coarse = o[name[:3] if name != "port" else name]
        with conf.config_overrides(**dict(cfg, **extra)):
            out[name] = run(o["K"], o["M"], msh, bc, o["f"], o["u0"], o["v0"],
                            o["dt"], 8, vdim=vdim, mg_level_builder=coarse)
    p, r, r64 = out["port"], out["ref"], out["ref64"]
    assert p.values.shape == r.values.shape == (9,) + o["u0"].shape
    assert p.values.dtype == p.velocities.dtype == np.float64
    assert np.array_equal(p.times, r.times)
    assert np.array_equal(p.values[0], o["u0"])
    assert np.array_equal(p.velocities[0], o["v0"])
    # two float32 scans.  Scalar: measured ≤ 2e-7.  Elasticity blocks: the
    # accelerations are differences of large terms (f − K ũ), so the two
    # scans lie up to 5.8e-6 apart (velocities, vdim 2) — and each as far
    # from the float64 scan
    tol = 1e-6 if vdim == 1 else 2e-5
    for got, want, want64 in ((p.values, r.values, r64.values),
                              (p.velocities, r.velocities, r64.velocities)):
        assert _gap(got, want) <= tol
        assert _gap(got, want64) <= 1.5 * _gap(want, want64) + 1e-6
    assert max(p.max_relative_residual, r.max_relative_residual) <= 1e-8
    # the same solver took the steps: within 5 % + 2 iterations
    assert abs(p.total_cg_iterations - r.total_cg_iterations) \
        <= 0.05 * r.total_cg_iterations + 2
    if solver == "MG-PCG":
        assert p.total_cg_iterations < 8 * 20


def test_run_newmark_mg_takes_fewer_iterations_than_flat_cg():
    o = _newmark_operands(3)
    msh, bc, coarse = o["port"]
    its = {}
    for name, cfg in (("cg", TRANSIENT), ("mg", dict(TRANSIENT, **MG))):
        with config.config_overrides(device="cpu", **cfg):
            res = timestepping.run_newmark(
                o["K"], o["M"], msh, bc, o["f"], o["u0"], o["v0"], o["dt"], 6,
                vdim=3, mg_level_builder=coarse)
        its[name] = (res.total_cg_iterations, res.values)
    assert its["mg"][0] < its["cg"][0]
    assert _gap(its["mg"][1], its["cg"][1]) <= 1e-6


@pytest.mark.parametrize("vdim,path", [(1, "host LU"), (3, "host LU"),
                                       (2, "device CG")])
def test_smallest_modes_matches_reference_on_the_same_operands(vdim, path):
    o = _newmark_operands(vdim)
    cfg = MIXED if path == "device CG" else {}
    out = {}
    for name, eig, conf, extra in (("port", eigen, config, {"device": "cpu"}),
                                   ("ref", ref_eigen, ref_config, {})):
        msh, bc, _ = o[name]
        with conf.config_overrides(**cfg, **extra):
            out[name] = eig.smallest_modes(o["K"], o["M"], msh, bc,
                                           num_modes=2, vdim=vdim, seed=5)
    (lams, modes, info), (lams_r, modes_r, info_r) = out["port"], out["ref"]
    assert info["converged"] and info_r["converged"]
    assert info["iterations"] == info_r["iterations"]
    tol = 1e-9 if path == "host LU" else 1e-6
    assert np.abs(lams - lams_r).max() <= tol * lams_r.max()
    # same start block (seed 5) and same arithmetic: the vectors
    # themselves agree, sign included
    assert _gap(modes, modes_r) <= max(tol, 1e-8)


# ----------------------------------------------------------------------
# The in-memory multigrid cache
# ----------------------------------------------------------------------

def _cantilever(cells=(8, 4, 4)):
    msh = box_mesh(*cells, (0, 0, 0), (1.0, 0.25, 0.25))
    lam, mu = elast.lame_parameters(1e6, 0.3, "3d")
    K = assembly.assemble_elasticity_stencil(msh, lam, mu)
    bc = DirichletBC.from_masks([(msh.face_mask(0, 0), 0.0)],
                                msh.node_shape, vdim=3)

    def coarse(m):
        return (assembly.assemble_elasticity_stencil(m, lam, mu),
                DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)],
                                       m.node_shape, vdim=3))
    return msh, K, bc, coarse


def _solve(cells, seed, device="cpu"):
    msh, K, bc, coarse = _cantilever(cells)
    rhs = np.random.default_rng(seed).standard_normal(msh.node_shape + (3,))
    with config.config_overrides(device=device, mg_threshold=100, **MIXED):
        return linsolve.solve_stencil_system(K, msh, bc, rhs, vdim=3,
                                             mg_level_builder=coarse)


def test_mg_cache_second_solve_builds_nothing_and_is_bit_equal(builds):
    x1, st1 = _solve((8, 4, 4), 1)
    assert builds == [(9, 5, 5)] and st1.converged
    x2, st2 = _solve((8, 4, 4), 2)            # another right side: a hit
    assert builds == [(9, 5, 5)]
    assert len(linsolve._MG_CACHE) == 1
    linsolve._MG_CACHE.clear()
    x2_cold, st2_cold = _solve((8, 4, 4), 2)  # the same solve, uncached
    assert builds == [(9, 5, 5)] * 2
    assert np.array_equal(x2, x2_cold)
    assert int(st2.iterations) == int(st2_cold.iterations)
    assert not np.array_equal(x1, x2)
    # the cached host arrays are shared, so read-only
    hierarchy, ladder = next(iter(linsolve._MG_CACHE.values()))
    assert ladder is not None
    for lv in hierarchy.levels:
        assert not any(w.flags.writeable for w in lv.host_weights)
    assert not hierarchy.levels[-1].host_Ainv.flags.writeable


def test_mg_cache_misses_on_routing_and_device(builds, monkeypatch):
    _solve((8, 4, 4), 1)
    monkeypatch.setenv("PDE_TPU_CS", "1")
    _solve((8, 4, 4), 1)
    assert len(builds) == 2
    monkeypatch.setattr(ck, "CS_MIN_DOF", 100)    # the size gate is routing
    _solve((8, 4, 4), 1)
    assert len(builds) == 3
    monkeypatch.setenv("PDE_TPU_CS", "0")
    msh, K, bc, _ = _cantilever()
    sysm = linsolve.prepare_system(K, msh, bc, np.zeros(msh.node_shape + (3,)),
                                   3)
    import torch
    keys = {linsolve._mg_cache_key(msh, 3, "mixed", sysm, torch.device(d))
            for d in ("cpu", "cuda", "cuda:1")}
    assert len(keys) == 3


def test_mg_cache_third_operator_evicts_the_first(builds):
    for cells in ((8, 4, 4), (4, 8, 4), (4, 4, 8)):
        _solve(cells, 1)
    assert len(builds) == 3 and len(linsolve._MG_CACHE) == 2
    _solve((4, 4, 8), 2)                      # the newest: a hit
    _solve((4, 8, 4), 2)                      # the second: a hit
    assert len(builds) == 3
    _solve((8, 4, 4), 2)                      # the first was evicted
    assert builds[-1] == (9, 5, 5) and len(builds) == 4
    assert len(linsolve._MG_CACHE) == 2


# ----------------------------------------------------------------------
# What stays unported raises
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg,match", [
    (dict(transient_checkpoint_every=2), "step H"),
    (dict(precision="f64"), "step H"),
    (dict(precision="auto"), "step H"),       # the CPU resolves it to f64
    (dict(shard_devices=4), "step I"),
    (dict(shard_grid="2,2"), "step I"),
])
def test_unported_newmark_options_raise(cfg, match, tmp_path):
    cfg = dict(dict(device="cpu", precision="f32"), **cfg)
    with config.config_overrides(**cfg):
        for tool, kw in (("solve_wave_1D", dict(nx=8, num_steps=1)),
                         ("solve_elasticity_3D_dynamic",
                          dict(nx=2, ny=2, nz=2, num_steps=1))):
            with pytest.raises(NotImplementedError, match=match):
                getattr(api, tool)(**kw, data_dir=str(tmp_path))


# ----------------------------------------------------------------------
# The reference's closed forms, against the port alone (test_wave.py)
# ----------------------------------------------------------------------

def test_wave_1d_standing_mode_analytic():
    """u0 = sin(πx/L), fixed ends: u(x,t) = sin(πx/L)·cos(ωt), ω = cπ/L."""
    L, c = 2.0, 3.0
    mesh = interval_mesh(96, 0.0, L)
    omega = c * np.pi / L
    period = 2 * np.pi / omega
    n = 200
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                    initial_amplitude=1.0, initial_wavenumber=np.pi / L,
                    dt=period / n, num_steps=n)
    times, values, info = solve_wave_problem(p, config=F32)
    assert info["converged"]
    x = mesh.axis_nodes(0)
    exact = np.sin(np.pi * x / L)[None, :] * np.cos(omega * times)[:, None]
    assert np.linalg.norm(values - exact) / np.linalg.norm(exact) < 2e-2
    assert np.linalg.norm(values[-1] - values[0]) \
        / np.linalg.norm(values[0]) < 3e-2
    assert np.linalg.norm(values[n // 2] + values[0]) \
        / np.linalg.norm(values[0]) < 3e-2


def test_wave_1d_newmark_dt_convergence_order2():
    """Halving dt cuts the trajectory error ~4× (Newmark is O(dt²)); the
    anchor is a dt/8 run sampled at the coarse frames."""
    L, c = 1.0, 1.0
    mesh = interval_mesh(48, 0.0, L)
    period = 2 * L / c
    runs = {}
    for n in (800, 100, 50):
        p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                        initial_wavenumber=np.pi / L,
                        dt=period / n, num_steps=n)
        _, values, _ = solve_wave_problem(p, config=F32)
        runs[n] = values
    errs = {n: np.linalg.norm(runs[n] - runs[800][::800 // n])
            / np.linalg.norm(runs[800][::800 // n]) for n in (100, 50)}
    ratio = errs[50] / errs[100]
    assert 3.3 < ratio < 4.8, (errs, ratio)


def test_wave_2d_membrane_mode_frequency():
    """Unit membrane fundamental: u0 = sin(πx)sin(πy), ω = cπ√2."""
    c = 2.0
    mesh = rectangle_mesh(40, 40, (0.0, 0.0), (1.0, 1.0))
    period = 2 * np.pi / (c * np.pi * np.sqrt(2.0))
    n = 120
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                    initial_wavenumber=np.pi, dt=period / n, num_steps=n)
    times, values, info = solve_wave_problem(p, config=F32)
    assert info["converged"]
    mid = values[:, values.shape[1] // 2]
    assert abs(values[n // 2].min() + values[0].max()) \
        / values[0].max() < 5e-2
    assert np.linalg.norm(values[-1] - values[0]) \
        / np.linalg.norm(values[0]) < 6e-2
    assert mid.max() <= 1.0 + 5e-3


def _energies(res, Kd, Md):
    return np.asarray([0.5 * v.reshape(-1) @ Md @ v.reshape(-1)
                       + 0.5 * u.reshape(-1) @ Kd @ u.reshape(-1)
                       for u, v in zip(res.values, res.velocities)])


def test_wave_energy_conservation():
    """β=¼, γ=½, f=0: E = ½vᵀMv + ½uᵀ(c²K)u is conserved.  The reference's
    float64 scan holds 1e-8; a float32 state rounds at 6e-8 a step through
    150 steps: measured 1.8e-7, bound 2e-6."""
    c = 2.0
    mesh = interval_mesh(32, 0.0, 1.0)
    K = {o: c * c * W for o, W in
         assembly.assemble_scalar_stencil(mesh, "stiffness").items()}
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    u0 = np.sin(np.pi * mesh.axis_nodes(0))
    res = timestepping.run_newmark(K, M, mesh, bc, np.zeros_like(u0), u0,
                                   np.zeros_like(u0), 0.004, 150, config=F32)
    E = _energies(res, assembly.stencil_to_dense(mesh, K),
                  assembly.stencil_to_dense(mesh, M))
    assert np.abs(E - E[0]).max() / E[0] < 2e-6


def test_wave_constant_source_steady_limit():
    """Under a constant source u oscillates about the static solution of
    −c²Δu = f: the mean over whole periods approximates it."""
    c, L, f = 1.0, 1.0, 5.0
    mesh = interval_mesh(64, 0.0, L)
    period = 2 * L / c
    n_per = 100
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="zero",
                    source_value=f, dt=period / n_per, num_steps=4 * n_per)
    _, values, _ = solve_wave_problem(p, config=F32)
    x = mesh.axis_nodes(0)
    static = f * x * (L - x) / (2 * c * c)
    mean = values[1:].mean(axis=0)
    assert np.linalg.norm(mean - static) / np.linalg.norm(static) < 0.08


def test_wave_api_tools(tmp_path):
    """solve_wave_{1,2,3}D artifacts: shapes, meta keys, default IC mode."""
    with config.config_overrides(device="cpu", precision="f32"):
        res1 = api.solve_wave_1D(length=1.0, nx=24, wave_speed=2.0, dt=0.005,
                                 num_steps=8, data_dir=str(tmp_path))
        res2 = api.solve_wave_2D(nx=8, ny=8, dt=0.01, num_steps=3,
                                 data_dir=str(tmp_path))
        res3 = api.solve_wave_3D(nx=5, ny=5, nz=5, dt=0.01, num_steps=2,
                                 data_dir=str(tmp_path))
    f1 = load_field(res1.data_file)
    assert f1.values.shape == (9, 25) and f1.coords.shape == (25, 3)
    assert f1.meta["pde"] == "wave_1d" and f1.meta["wave_speed"] == 2.0
    assert f1.meta["name"] == "displacement"
    assert f1.meta["integrator"] == "newmark_beta"
    assert abs(f1.values[0, 0]) < 1e-12 and abs(f1.values[0, -1]) < 1e-12
    assert abs(f1.values[0].max() - 1.0) < 5e-3
    f2 = load_field(res2.data_file)
    assert f2.values.shape == (4, 81) and f2.dim == 2
    f3 = load_field(res3.data_file)
    assert f3.values.shape == (3, 216) and f3.dim == 3
    assert "solver_stats" in f3.meta


# ----------------------------------------------------------------------
# test_dynamics.py
# ----------------------------------------------------------------------

def _dense_perm(mesh, vdim):
    """Map C-order grid DOFs → stencil_to_dense's x-fastest numbering."""
    shape = mesh.node_shape
    N = int(np.prod(shape))
    idx = np.arange(N).reshape(tuple(reversed(shape))).transpose(
        tuple(reversed(range(len(shape)))))
    return (idx.reshape(-1)[:, None] * vdim + np.arange(vdim)).reshape(-1)


def _dense_newmark(Kd, Md, free, f, u0, v0, dt, num_steps,
                   beta=0.25, gamma=0.5):
    """Dense numpy Newmark on the constrained subsystem (float64)."""
    idx = np.flatnonzero(free.reshape(-1))
    K = Kd[np.ix_(idx, idx)]
    M = Md[np.ix_(idx, idx)]
    ff = f.reshape(-1)[idx]
    u = u0.reshape(-1)[idx].copy()
    v = v0.reshape(-1)[idx].copy()
    a = np.linalg.solve(M, ff - K @ u)
    A_eff = M + beta * dt * dt * K
    us = [u0.reshape(-1).copy()]
    for _ in range(num_steps):
        u_pred = u + dt * v + dt * dt * (0.5 - beta) * a
        a_new = np.linalg.solve(A_eff, ff - K @ u_pred)
        u = u_pred + beta * dt * dt * a_new
        v = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        a = a_new
        full = np.zeros(u0.size)
        full[idx] = u
        us.append(full)
    return np.stack(us)


def test_newmark_matches_dense_reference_2d():
    """Block-scaled (vdim=2) Newmark scan against a dense float64 numpy
    integration.  The reference's float64 scan holds 1e-9 (relative L2); the
    float32 scan measured 3.0e-7, bound 3e-6."""
    mesh = rectangle_mesh(6, 5, (0.0, 0.0), (1.2, 1.0))
    lam, mu = elast.lame_parameters(10.0, 0.3, "plane_stress")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    M = elast.assemble_vector_mass(mesh, rho=2.0)
    f = assembly.assemble_vector_load(mesh, np.array([0.0, -1.0]))
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    shape = mesh.node_shape + (2,)
    u0, v0 = np.zeros(shape), np.zeros(shape)
    dt, n = 0.02, 25
    res = timestepping.run_newmark(K, M, mesh, bc, f, u0, v0, dt, n, vdim=2,
                                   config=F32)
    perm = _dense_perm(mesh, 2)

    def reorder(g):
        out = np.empty(g.size)
        out[perm] = g.reshape(-1)
        return out

    ref = _dense_newmark(assembly.stencil_to_dense(mesh, K, vdim=2),
                         assembly.stencil_to_dense(mesh, M, vdim=2),
                         reorder(np.asarray(bc.free_mask)), reorder(f),
                         reorder(u0), reorder(v0), dt, n)
    got = np.stack([reorder(res.values[k]) for k in range(n + 1)])
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err < 3e-6, err


def test_newmark_energy_conservation():
    """β=¼, γ=½, f=0 on a fixed-free bar: the discrete energy is conserved.
    The reference's float64 scan holds 1e-8 over 200 steps; the float32
    scan measured 8.7e-7, bound 5e-6."""
    mesh = interval_mesh(24, 0.0, 1.0)
    E, rho = 50.0, 1.0
    K = {o: E * W for o, W in
         assembly.assemble_scalar_stencil(mesh, "stiffness").items()}
    M = {o: rho * W for o, W in
         assembly.assemble_scalar_stencil(mesh, "mass").items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    u0 = 0.01 * np.sin(0.5 * np.pi * mesh.axis_nodes(0))
    res = timestepping.run_newmark(K, M, mesh, bc, np.zeros_like(u0), u0,
                                   np.zeros_like(u0), 0.005, 200, config=F32)
    energies = _energies(res, assembly.stencil_to_dense(mesh, K),
                         assembly.stencil_to_dense(mesh, M))
    drift = np.abs(energies - energies[0]).max() / energies[0]
    assert drift < 5e-6, drift


def test_newmark_bar_frequency():
    """Fixed-free bar fundamental frequency ω₁ = (π/2)·√(E/ρ)/L."""
    L, E, rho = 1.0, 100.0, 1.0
    mesh = interval_mesh(64, 0.0, L)
    K = {o: E * W for o, W in
         assembly.assemble_scalar_stencil(mesh, "stiffness").items()}
    M = {o: rho * W for o, W in
         assembly.assemble_scalar_stencil(mesh, "mass").items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    u0 = 1e-3 * np.sin(0.5 * np.pi * mesh.axis_nodes(0) / L)
    period = 2 * np.pi / (0.5 * np.pi * np.sqrt(E / rho) / L)
    n = 160
    res = timestepping.run_newmark(K, M, mesh, bc, np.zeros_like(u0), u0,
                                   np.zeros_like(u0), period / n, n,
                                   config=F32)
    tip = res.values[:, -1]
    assert abs(tip[-1] - tip[0]) / abs(tip[0]) < 2e-2
    assert abs(tip[n // 2] + tip[0]) / abs(tip[0]) < 2e-2


def test_elastodynamics_model_entry():
    """A cantilever released under gravity oscillates about the static
    equilibrium with bounded amplitude, and its clamped face never moves."""
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.25, 0.25))
    E, nu, rho = 1e6, 0.3, 10.0
    g = np.array([0.0, 0.0, -9.81 * rho])
    res, info = elast.solve_elasticity_dynamic(
        mesh, E, nu, rho, g, "3d", dt=2e-3, num_steps=40, config=F32)
    assert res.values.shape == res.velocities.shape == (41, 9, 5, 5, 3)
    assert info["cg_iterations"] > 0 and info["converged"]
    uz = res.values[..., 2].reshape(41, -1)
    with config.config_overrides(device="cpu"):      # 675 DOF: host LU
        disp, _ = elast.solve_elasticity_nd(mesh, E, nu, g, "3d",
                                            quantity="displacement")
    static = np.abs(disp).max()
    # it swings between 0 and about twice the static deflection (1.98×)
    assert 1.5 * static < np.abs(uz).max() < 2.2 * static
    assert np.abs(res.values[:, 0, :, :, :]).max() == 0.0
    assert np.abs(res.velocities[:, 0, :, :, :]).max() == 0.0


def test_newmark_mg_step_solves_match_plain():
    """MG-PCG step solves match the plain-CG path.  The reference's float64
    scans agree to 1e-8; float32 scans, whose right side f − K ũ is a
    difference of large terms: measured 6.9e-6, bound 2e-5."""
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.25, 0.25))
    g = np.array([0.0, 0.0, -98.1])
    kw = dict(dt=2e-3, num_steps=10)
    cfg_mg = config.SolverConfig(device="cpu", precision="f32",
                                 transient_inner_tol=1e-7, mg_threshold=100,
                                 transient_mg_threshold=100)
    res_mg, info_mg = elast.solve_elasticity_dynamic(
        mesh, 1e6, 0.3, 10.0, g, "3d", config=cfg_mg, **kw)
    res_cg, info_cg = elast.solve_elasticity_dynamic(
        mesh, 1e6, 0.3, 10.0, g, "3d", config=F32, **kw)
    scale = np.abs(res_cg.values).max()
    assert np.abs(res_mg.values - res_cg.values).max() < 2e-5 * scale
    assert info_mg["cg_iterations"] < info_cg["cg_iterations"]


# ----------------------------------------------------------------------
# test_eigen.py
# ----------------------------------------------------------------------

CPU = config.SolverConfig(device="cpu")      # ≤ 4,000 DOF: host sparse LU


def test_laplacian_square_spectrum():
    """π²(m²+n²): 2π², 5π² (twice), 8π²; tight against the dense
    generalized eigenproblem of the same discretisation."""
    from scipy.linalg import eigh

    mesh = rectangle_mesh(24, 24, (0, 0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    lams, modes, info = eigen.smallest_modes(K, M, mesh, bc, num_modes=4,
                                             config=CPU)
    assert info["converged"]
    pi2 = np.pi ** 2
    np.testing.assert_allclose(lams, [2 * pi2, 5 * pi2, 5 * pi2, 8 * pi2],
                               rtol=2e-2)
    A = assembly.stencil_to_dense(mesh, K)
    B = assembly.stencil_to_dense(mesh, M)
    free = flatten_values(np.asarray(bc.free_mask), 2).astype(bool)
    w = eigh(A[np.ix_(free, free)], B[np.ix_(free, free)],
             eigvals_only=True, subset_by_index=[0, 3])
    np.testing.assert_allclose(lams, w, rtol=1e-6)
    for i in range(4):
        Mi = B @ flatten_values(modes[i], 2)
        for j in range(4):
            np.testing.assert_allclose(flatten_values(modes[j], 2) @ Mi,
                                       1.0 if i == j else 0.0, atol=1e-7)


def test_axial_bar_frequencies():
    """Fixed-free bar: ω_n = (2n−1)πc/(2L), c = √(E/ρ)."""
    E, rho, A_cs, L = 200e9, 7800.0, 1.0, 2.0
    c = np.sqrt(E / rho)
    mesh = interval_mesh(256, 0.0, L)
    K = {o: E * A_cs * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    M = {o: rho * A_cs * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "mass").items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    lams, _, info = eigen.smallest_modes(K, M, mesh, bc, num_modes=3,
                                         config=CPU)
    assert info["converged"]
    exact = np.array([(2 * n - 1) * np.pi * c / (2 * L)
                      for n in (1, 2, 3)]) ** 2
    np.testing.assert_allclose(lams, exact, rtol=1e-3)


def test_elasticity_modes_match_dense():
    """3D clamped box, vector P1: subspace iteration matches the dense
    eigenvalues of the same discrete pencil."""
    from scipy.linalg import eigh

    lam_p, mu = elast.lame_parameters(10e9, 0.3, "3d")
    mesh = box_mesh(6, 3, 3, (0, 0, 0), (1.0, 0.4, 0.4))
    K = assembly.assemble_elasticity_stencil(mesh, lam_p, mu)
    M = elast.assemble_vector_mass(mesh, 2000.0)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    lams, modes, info = eigen.smallest_modes(K, M, mesh, bc, num_modes=4,
                                             vdim=3, config=CPU)
    assert info["converged"]
    A = assembly.stencil_to_dense(mesh, K, vdim=3)
    B = assembly.stencil_to_dense(mesh, M, vdim=3)
    free = flatten_values(np.asarray(bc.free_mask), 3).reshape(-1).astype(bool)
    w = eigh(A[np.ix_(free, free)], B[np.ix_(free, free)],
             eigvals_only=True, subset_by_index=[0, 3])
    np.testing.assert_allclose(lams, w, rtol=1e-6)
    np.testing.assert_allclose(lams[0], lams[1], rtol=0.25)
    assert np.isfinite(modes).all()


def test_modal_api_artifact(tmp_path):
    with config.config_overrides(device="cpu"):
        res = api.solve_elasticity_3D_modal(nx=8, ny=4, nz=4, num_modes=3,
                                            data_dir=str(tmp_path))
    f = load_field(res.data_file)
    freqs = f.meta["frequencies_hz"]
    assert len(freqs) == 3 and all(freqs[i] <= freqs[i + 1] + 1e-9
                                   for i in range(2))
    v = f.values_array()
    assert v.shape[0] == 3
    assert np.allclose(v.max(axis=1), 1.0)
    x = f.coords_array()[:, 0]
    assert np.allclose(v[:, x == 0.0], 0.0, atol=1e-12)
    assert f.meta["solver_stats"]["converged"]


def test_modal_2d_api(tmp_path):
    with config.config_overrides(device="cpu"):
        res = api.solve_elasticity_2D_modal(nx=12, ny=4, num_modes=2,
                                            data_dir=str(tmp_path))
    f = load_field(res.data_file)
    assert len(f.meta["frequencies_hz"]) == 2 and f.dim == 2
    assert f.meta["pde"] == "elasticity_modal" and f.meta["plane_stress"]
    assert f.meta["solver_stats"]["converged"]
