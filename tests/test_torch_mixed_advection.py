"""The ``_mixed`` (Robin / flux / periodically driven faces), nonlinear
Picard and advection (CNAB2) tool families of the port against the JAX
package at small sizes: signatures, meta, coordinates, times and values of
all nine tools, through the host-direct path (≤1e-9), the mixed path (≤1e-6)
and transients at θ = 1 and 0.5 (≤1e-6 at ``transient_inner_tol=1e-8``);
``run_transient`` of both packages on the same numpy operands with
``time_mod`` and ``C_np``; the face parser; the closed forms the JAX
package's own tests use, run against the port alone; and the size gate of
the constant-interior route.

The port evaluates the driving sinusoid on the host in float64 and the JAX
package in the float32 state type: a relative difference of ~1e-7 in the
driven terms, inside the 1e-6 bound of the transient comparisons."""

import inspect

import numpy as np
import pytest
import torch

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu.models import advection as ref_adv
from pde_solver_tpu.models import heat as ref_heat
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch import api
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch import mesh as port_mesh
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.models import advection as adv
from pde_solver_tpu_torch.models import heat
from pde_solver_tpu_torch.ops import assembly, surface
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from pde_solver_tpu_torch.ops import timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.utils.kept import Kept
from torch_stats import same_keys

TOOLS = ("solve_heat_1D_mixed", "solve_heat_2D_mixed", "solve_heat_3D_mixed",
         "solve_heat_radial_mixed", "solve_heat_1D_nonlinear",
         "solve_heat_2D_nonlinear", "solve_advection_1D",
         "solve_advection_2D", "solve_advection_3D")
MIXED = dict(precision="mixed", host_direct_threshold=0, mg_threshold=100)
TRANSIENT = dict(precision="f32", transient_inner_tol=1e-8)
CPU = dict(device="cpu", precision="f32")
# all three face kinds at once, the Dirichlet face driven with a phase
FACES = {"left": {"type": "dirichlet", "value": 100.0, "amplitude": 20.0,
                  "period": 0.1, "phase": 0.3},
         "right": {"type": "robin", "h": 5.0, "T_ambient": 20.0},
         "top": {"type": "neumann", "flux": 50.0},
         "bottom": {"type": "insulated"}}
FACES_1D = {k: FACES[k] for k in ("left", "right")}
RADIAL = {"inner": {"type": "dirichlet", "value": 50.0, "amplitude": 5.0,
                    "omega": 30.0, "phase": 0.2},
          "outer": {"type": "robin", "h": 8.0, "T_ambient": 20.0}}
# small sizes per tool
MIXED_TOOLS = {
    "solve_heat_1D_mixed": dict(nx=24, boundary_conditions=FACES_1D),
    "solve_heat_2D_mixed": dict(nx=8, ny=6, boundary_conditions=FACES),
    "solve_heat_3D_mixed": dict(nx=6, ny=5, nz=4, boundary_conditions=FACES),
    "solve_heat_radial_mixed": dict(kind="sphere", r_inner=0.5, nr=24,
                                    boundary_conditions=RADIAL)}
ADVECTION = {
    "solve_advection_1D": dict(nx=32, diffusivity=0.05),
    "solve_advection_2D": dict(nx=10, ny=8, vx=0.8, vy=-0.3,
                               diffusivity=0.05),
    "solve_advection_3D": dict(nx=6, ny=5, nz=4, vx=0.8, vy=-0.3, vz=0.2,
                               diffusivity=0.1)}


def _run(tool, tmp_path, cfg, **kw):
    """One tool through both packages under the same config; returns
    (port, reference) as (values, times, coords, meta)."""
    out = []
    for pkg, conf, load, extra in (
            (api, config, load_field, {"device": "cpu"}),
            (ref_api, ref_config, ref_load, {})):
        with conf.config_overrides(**cfg, **extra):
            r = getattr(pkg, tool)(**kw, data_dir=str(tmp_path / pkg.__name__))
        f = load(r.data_file)
        out.append((f.values_array(), f.times_array(), f.coords_array(),
                    r.meta))
    return out


def _check(port, ref, tol):
    (v, t, c, meta), (v_ref, t_ref, c_ref, meta_ref) = port, ref
    assert {k: x for k, x in meta.items() if k != "solver_stats"} == \
        {k: x for k, x in meta_ref.items() if k != "solver_stats"}
    assert same_keys(meta["solver_stats"], meta_ref["solver_stats"])
    assert meta["solver_stats"]["converged"], meta["solver_stats"]
    assert np.array_equal(c, c_ref)
    assert np.array_equal(t, t_ref)
    assert v.shape == v_ref.shape
    assert np.all(np.isfinite(v))
    gap = np.abs(v - v_ref).max() / np.abs(v_ref).max()
    assert gap <= tol, gap


@pytest.mark.parametrize("tool", TOOLS)
def test_signature_matches_reference(tool):
    assert inspect.signature(getattr(api, tool)) == \
        inspect.signature(getattr(ref_api, tool))


# ----------------------------------------------------------------------
# The face parser
# ----------------------------------------------------------------------

FACE_NAMES = ("left", "right", "bottom", "top", "front", "back", "x_min",
              "x_max", "y_min", "y_max", "z_min", "z_max", "start", "end",
              "inner", "inside", "outer", "outside", "all", "boundary",
              "everywhere", "sides", "side", "lateral", "walls", " Top ",
              "nowhere")


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_face_keys_equal_reference(dim):
    assert heat._FACE_NAMES == ref_heat._FACE_NAMES
    assert heat._FACE_ALIASES == ref_heat._FACE_ALIASES
    for name in FACE_NAMES:
        assert _outcome(heat._face_keys, dim, name) == \
            _outcome(ref_heat._face_keys, dim, name), name
    assert _outcome(heat._face_keys, dim, "nowhere")[0] == "ValueError"


SPECS = (
    None,
    {},
    {"left": 20.0, "right": 5},
    FACES,
    {"all": {"type": "convection", "h": 3.0, "t_inf": 15.0}},
    {"sides": {"type": "flux", "value": 7.0}, "x_min": {"type": "fixed"}},
    {"left": {"type": "temperature", "value": 1.0, "amplitude": 2.0,
              "omega": 4.0}, "outer": {"type": "adiabatic"}},
    {"left": {"type": "dirichlet", "amplitude": 2.0, "period": 0.0},
     "right": {"type": "convective", "ambient": 4.0}},
    {"end": {"type": "heat_flux", "flux": -3.0},
     "start": {"type": "robin", "t_ambient": 9.0}},
    {"left": {"type": "radiative"}},
    {"ceiling": 3.0},
)


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_parse_face_bcs_equal_reference(i):
    for dim in (1, 2, 3):
        assert _outcome(heat.parse_face_bcs, SPECS[i], dim) == \
            _outcome(ref_heat.parse_face_bcs, SPECS[i], dim)


@pytest.mark.parametrize("tool,kw,match", [
    ("solve_heat_2D_mixed",
     dict(boundary_conditions={"ceiling": 3.0}), "unknown face"),
    ("solve_heat_1D_mixed",
     dict(boundary_conditions={"left": {"type": "radiative"}}),
     "unknown BC type"),
    ("solve_heat_radial_mixed",
     dict(boundary_conditions={"top": 3.0}), "unknown radial face"),
    ("solve_heat_radial_mixed",
     dict(boundary_conditions={"outer": {"type": "radiative"}}),
     "unknown BC type"),
    ("solve_heat_radial_mixed", dict(kind="cube"), "kind must be"),
    ("solve_advection_1D", dict(nx=8, num_steps=1, scheme="rk4"),
     "unknown advection scheme"),
    ("solve_heat_1D_nonlinear", dict(nx=16, beta=-0.5), "non-positive"),
])
def test_value_errors_as_reference(tool, kw, match, tmp_path):
    for pkg, conf, extra in ((api, config, {"device": "cpu"}),
                             (ref_api, ref_config, {})):
        with conf.config_overrides(**extra):
            with pytest.raises(ValueError, match=match):
                getattr(pkg, tool)(**kw, data_dir=str(tmp_path))


def test_unknown_convection_scheme_and_unsteady_nonlinear_raise(
        tmp_path, monkeypatch):
    """Bad inputs raise.  Checkpointed, float64 and sharded scans, which
    raised until ported, run: the checkpointed scan bitwise the plain one,
    the float64 scan within 1e-9 of the JAX package's, the sharded float64
    scan (2 virtual shards) within 1e-9 of the port's unsharded one and of
    the JAX package's sharded one."""
    m = port_mesh.interval_mesh(8, 0.0, 1.0)
    K = assembly.assemble_scalar_stencil(m, "stiffness")
    M = assembly.assemble_scalar_stencil(m, "mass")
    bc = DirichletBC.from_masks([(m.boundary_mask(), 0.0)], m.node_shape)
    with config.config_overrides(**CPU):
        with pytest.raises(ValueError, match="unknown convection_scheme"):
            timestepping.run_transient(K, M, m, bc, np.zeros(9), np.zeros(9),
                                       0.1, 1, convection_scheme="rk4")
        with pytest.raises(ValueError, match="steady"):
            heat.solve_heat_nonlinear(heat.HeatProblem(mesh=m), 1.0, 0.01)
        u0 = np.sin(np.pi * m.axis_nodes(0))
        plain = timestepping.run_transient(K, M, m, bc, np.zeros(9), u0,
                                           0.1, 3).values
        with config.config_overrides(transient_checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path)):
            ckpt = timestepping.run_transient(K, M, m, bc, np.zeros(9), u0,
                                              0.1, 3).values
        assert np.array_equal(ckpt, plain)
    rm = ref_mesh.interval_mesh(8, 0.0, 1.0)
    v_ref = ref_ts.run_transient(
        ref_asm.assemble_scalar_stencil(rm, "stiffness"),
        ref_asm.assemble_scalar_stencil(rm, "mass"), rm,
        RefBC(bc.free_mask, bc.values), np.zeros(9), u0, 0.1, 3).values
    with config.config_overrides(device="cpu", precision="f64"):
        v = timestepping.run_transient(K, M, m, bc, np.zeros(9), u0, 0.1,
                                       3).values
    assert np.abs(v - v_ref).max() <= 1e-9 * np.abs(v_ref).max()
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "2")
    with config.config_overrides(device="cpu", precision="f64",
                                 shard_devices=2):
        v_sh = timestepping.run_transient(K, M, m, bc, np.zeros(9), u0, 0.1,
                                          3).values
    with ref_config.config_overrides(precision="f64", shard_devices=2):
        v_sh_ref = ref_ts.run_transient(
            ref_asm.assemble_scalar_stencil(rm, "stiffness"),
            ref_asm.assemble_scalar_stencil(rm, "mass"), rm,
            RefBC(bc.free_mask, bc.values), np.zeros(9), u0, 0.1, 3).values
    for ref in (v, v_sh_ref):
        assert v_sh.shape == ref.shape
        assert np.abs(v_sh - ref).max() <= 1e-9 * np.abs(ref).max()


# ----------------------------------------------------------------------
# The _mixed tools against the JAX package
# ----------------------------------------------------------------------

STEADY = {
    "1D robin+dirichlet": ("solve_heat_1D_mixed", dict(
        nx=24, boundary_conditions={
            "left": 100.0,
            "right": {"type": "robin", "h": 7.0, "T_ambient": 25.0}})),
    "1D pure robin": ("solve_heat_1D_mixed", dict(
        nx=24, diffusivity=1.5, source_type="constant", source_value=2.0,
        boundary_conditions={
            "left": {"type": "robin", "h": 3.0, "T_ambient": 80.0},
            "right": {"type": "robin", "h": 6.0, "T_ambient": 20.0}})),
    "1D flux": ("solve_heat_1D_mixed", dict(
        nx=16, diffusivity=4.0, boundary_conditions={
            "left": 0.0, "right": {"type": "neumann", "flux": 50.0}})),
    "2D all kinds": ("solve_heat_2D_mixed", dict(
        nx=8, ny=6, boundary_conditions=FACES, source_type="constant",
        source_value=3.0)),
    "3D all kinds": ("solve_heat_3D_mixed", dict(
        nx=6, ny=5, nz=4, boundary_conditions=dict(
            FACES, sides={"type": "robin", "h": 1.0, "T_ambient": 5.0}))),
    "cylinder solid": ("solve_heat_radial_mixed", dict(
        kind="cylinder", r_inner=0.0, nr=24, source_type="constant",
        source_value=4.0, boundary_conditions={
            "inner": 99.0,     # ignored: r = 0 is an axis
            "all": {"type": "robin", "h": 25.0, "T_ambient": 20.0}})),
    "cylinder hollow": ("solve_heat_radial_mixed", dict(
        kind="cylinder", r_inner=0.5, r_outer=2.0, nr=24,
        boundary_conditions={
            "inner": 100.0,
            "outer": {"type": "robin", "h": 3.0, "T_ambient": 20.0}})),
    "sphere solid": ("solve_heat_radial_mixed", dict(
        kind="sphere", r_inner=0.0, nr=24, source_type="constant",
        source_value=4.0, boundary_conditions={"surface": 30.0})),
    "sphere hollow": ("solve_heat_radial_mixed", dict(
        kind="sphere", r_inner=0.5, r_outer=1.5, nr=24, diffusivity=2.0,
        boundary_conditions={
            "inside": {"type": "flux", "flux": 12.0},
            "all": {"type": "robin", "h": 8.0, "T_ambient": 20.0}})),
}


@pytest.mark.parametrize("case", sorted(STEADY))
def test_steady_mixed_host_direct_matches_reference(case, tmp_path):
    tool, kw = STEADY[case]
    _check(*_run(tool, tmp_path, {}, steady=True, **kw), 1e-9)


@pytest.mark.parametrize("tool", ["solve_heat_2D_mixed",
                                  "solve_heat_3D_mixed"])
def test_steady_mixed_mg_path_matches_reference(tool, tmp_path):
    """MG + the double-f32 F-cycle, the Robin face mass on every level."""
    kw = dict(nx=16, ny=12) if tool == "solve_heat_2D_mixed" else \
        dict(nx=8, ny=6, nz=4)
    _check(*_run(tool, tmp_path, MIXED, steady=True,
                 boundary_conditions=FACES, **kw), 1e-6)


@pytest.mark.parametrize("theta", [1.0, 0.5])
@pytest.mark.parametrize("tool", sorted(MIXED_TOOLS))
def test_transient_mixed_matches_reference(tool, theta, tmp_path):
    """Robin + flux + insulated faces and a driven Dirichlet face with a
    phase, from a sine initial field where the tool takes one."""
    kw = dict(MIXED_TOOLS[tool], num_steps=4, dt=0.005)
    if tool == "solve_heat_1D_mixed":
        kw.update(initial_type="sine", initial_wavenumber=2.0)
    port, ref = _run(tool, tmp_path, dict(TRANSIENT, theta=theta), **kw)
    assert port[0].shape[0] == 5
    _check(port, ref, 1e-6)


def test_transient_radial_solid_cylinder_matches_reference(tmp_path):
    kw = dict(kind="cylinder", r_inner=0.0, nr=24, T_initial=400.0, dt=0.02,
              num_steps=4, boundary_conditions={
                  "all": {"type": "robin", "h": 25.0, "T_ambient": 20.0}})
    _check(*_run("solve_heat_radial_mixed", tmp_path, TRANSIENT, **kw), 1e-6)


def test_transient_mg_with_robin_on_coarse_levels(tmp_path, monkeypatch):
    """17² nodes with the MG thresholds lowered: every step solves by
    MG-PCG, whose coarse operators carry the Robin face mass."""
    built = []
    orig = heat._apply_surface_terms

    def spy(p, mesh, K):
        built.append(mesh.node_shape)
        return orig(p, mesh, K)

    monkeypatch.setattr(heat, "_apply_surface_terms", spy)
    cfg = dict(precision="mixed", transient_mg_threshold=100,
               mg_threshold=100, transient_inner_tol=1e-8)
    port, ref = _run("solve_heat_2D_mixed", tmp_path, cfg, nx=16, ny=16,
                     num_steps=3, dt=0.002, boundary_conditions=FACES)
    assert built[:3] == [(17, 17), (9, 9), (5, 5)]
    assert abs(port[3]["solver_stats"]["cg_iterations"]
               - ref[3]["solver_stats"]["cg_iterations"]) <= 1
    _check(port, ref, 1e-6)


def test_steady_modulated_face_is_not_driven(tmp_path):
    """A steady solve ignores the amplitude (no time_mod is built)."""
    port, ref = _run("solve_heat_2D_mixed", tmp_path, {}, nx=8, ny=6,
                     steady=True, boundary_conditions=FACES)
    _check(port, ref, 1e-9)
    left = port[2][:, 0] == 0.0
    assert np.all(port[0][0][left] == 100.0)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_source_amp_and_bc_amp_match_reference(theta):
    """``HeatProblem.source_amp`` (no tool exposes it) with a driven face,
    through ``solve_heat_problem`` of both packages."""
    out = []
    for pkg_mesh, pkg_heat, conf, extra in (
            (port_mesh, heat, config, {"device": "cpu"}),
            (ref_mesh, ref_heat, ref_config, {})):
        m = pkg_mesh.rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
        left = m.face_mask(0, 0)
        p = pkg_heat.HeatProblem(
            mesh=m, diffusivity=0.4, T_initial=5.0, dt=0.02, num_steps=5,
            theta=theta, bc_pairs=[(left, 20.0)], bc_amp_pairs=[(left, 7.0)],
            source_type="constant", source_value=1.0, source_amp=2.5,
            mod_omega=3.0, mod_phase=0.4, robin_faces=[(0, 1, 2.0, 10.0)])
        with conf.config_overrides(**TRANSIENT, **extra):
            out.append(pkg_heat.solve_heat_problem(p))
    (t, v, info), (t_ref, v_ref, info_ref) = out
    assert np.array_equal(t, t_ref) and info["converged"]
    assert same_keys(info, info_ref)
    assert np.abs(v - v_ref).max() / np.abs(v_ref).max() <= 1e-6


# ----------------------------------------------------------------------
# Nonlinear Picard against the JAX package
# ----------------------------------------------------------------------

NONLINEAR = {"solve_heat_1D_nonlinear": dict(nx=32, kappa0=2.0),
             "solve_heat_2D_nonlinear": dict(nx=10, ny=8, T_left=80.0,
                                             beta=0.02,
                                             source_type="constant",
                                             source_value=5.0)}


@pytest.mark.parametrize("path", ["host LU", "device CG"])
@pytest.mark.parametrize("tool", sorted(NONLINEAR))
def test_nonlinear_matches_reference(tool, path, tmp_path):
    cfg, tol = ({}, 1e-9) if path == "host LU" else (MIXED, 1e-6)
    port, ref = _run(tool, tmp_path, cfg, **NONLINEAR[tool])
    _check(port, ref, tol)
    assert port[3]["solver_stats"]["picard_iterations"] == \
        ref[3]["solver_stats"]["picard_iterations"]
    assert port[3]["solver_stats"]["nonlinear"] is True


def test_nonlinear_prepare_cache_is_bounded_and_never_stale(monkeypatch,
                                                            tmp_path):
    """Every Picard iteration solves a new K.  With the content-keyed
    ``prepare_system`` cache switched on for small systems, the result is
    bit-equal to the uncached one and the cache stays within its bound."""
    # the cache's disk entries go to this test's own directory
    monkeypatch.setenv("PDE_TPU_CACHE_DIR", str(tmp_path))
    m = port_mesh.rectangle_mesh(10, 8, (0, 0), (1.0, 1.0))

    def solve():
        p = heat.HeatProblem(
            mesh=m, steady=True, T_initial=50.0,
            bc_builder=lambda mm: [(mm.boundary_mask(), 0.0),
                                   (mm.face_mask(0, 0), 100.0)])
        with config.config_overrides(device="cpu"):
            return heat.solve_heat_nonlinear(p, 1.0, 0.02)

    _, v_plain, info = solve()
    assert info["picard_iterations"] > linsolve._PREP_CACHE.size
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 0)
    monkeypatch.setattr(linsolve, "_PREP_CACHE",
                        Kept(linsolve._PREP_CACHE.size))
    _, v_cached, info_c = solve()
    assert 0 < len(linsolve._PREP_CACHE) <= linsolve._PREP_CACHE.size
    assert np.array_equal(v_cached, v_plain)
    assert info_c["picard_iterations"] == info["picard_iterations"]


def test_cell_average_equals_reference():
    rng = np.random.default_rng(0)
    for shape in ((9,), (5, 7), (4, 5, 6)):
        T = rng.standard_normal(shape)
        out = heat._cell_average(T, len(shape))
        assert out.shape == tuple(s - 1 for s in shape)
        assert np.array_equal(out, ref_heat._cell_average(T, len(shape)))


# ----------------------------------------------------------------------
# Advection against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["ab1", "cnab2"])
@pytest.mark.parametrize("tool", sorted(ADVECTION))
def test_advection_matches_reference(tool, scheme, tmp_path):
    port, ref = _run(tool, tmp_path, TRANSIENT, num_steps=6, scheme=scheme,
                     source_type="constant", source_value=0.5,
                     **ADVECTION[tool])
    assert port[3]["scheme"] == scheme and port[0].shape[0] == 7
    for key in ("cfl", "cell_peclet", "scheme"):
        assert port[3]["solver_stats"][key] == ref[3]["solver_stats"][key]
    _check(port, ref, 1e-6)


def test_advection_scheme_alias_and_pulse_center(tmp_path):
    port, ref = _run("solve_advection_2D", tmp_path, TRANSIENT, nx=10, ny=8,
                     num_steps=3, scheme="imex1", pulse_center_x=0.3,
                     T_boundary=1.0, T_initial=1.0, diffusivity=0.05)
    assert port[3]["scheme"] == "ab1"
    _check(port, ref, 1e-6)


@pytest.mark.parametrize("case", ["cnab2", "driven face"])
def test_snapshot_thinning_carries_the_history(case, tmp_path):
    """8 steps kept in 3 frames (every third, then the last): the CNAB2
    history and the driving phase run through the thinned frames."""
    cfg = dict(TRANSIENT, snapshot_max_frames=3)
    if case == "cnab2":
        tool, kw = "solve_advection_2D", dict(ADVECTION["solve_advection_2D"])
    else:
        tool, kw = "solve_heat_1D_mixed", dict(
            MIXED_TOOLS["solve_heat_1D_mixed"], dt=0.005)
    port, ref = _run(tool, tmp_path, cfg, num_steps=8, **kw)
    assert port[0].shape[0] == 4
    _check(port, ref, 1e-6)
    full, _ = _run(tool, tmp_path / "full", TRANSIENT, num_steps=8, **kw)
    assert np.array_equal(port[0], full[0][[0, 3, 6, 8]])


def test_initial_field_equals_reference():
    for center in (None, (0.4, 0.6)):
        fields = []
        for pkg_mesh, pkg_adv in ((port_mesh, adv), (ref_mesh, ref_adv)):
            m = pkg_mesh.rectangle_mesh(6, 5, (0.0, 0.5), (1.0, 1.0))
            for kind in ("gaussian", "constant"):
                fields.append(pkg_adv._initial_field(pkg_adv.AdvectionProblem(
                    mesh=m, velocity=[1.0, 0.0], T_initial=2.0,
                    initial_type=kind, pulse_center=center,
                    pulse_width=0.2, pulse_amplitude=3.0)))
        assert np.array_equal(fields[0], fields[2])
        assert np.array_equal(fields[1], fields[3])


# ----------------------------------------------------------------------
# run_transient of both packages on the same numpy operands
# ----------------------------------------------------------------------

def _operands(pkg_mesh, pkg_asm, bc_cls):
    m = pkg_mesh.rectangle_mesh(7, 6, (0, 0), (1.0, 1.2))
    K = {o: 0.3 * W for o, W in
         pkg_asm.assemble_scalar_stencil(m, "stiffness").items()}
    M = pkg_asm.assemble_scalar_stencil(m, "mass")
    C = pkg_asm.assemble_convection_stencil(m, np.array([0.8, -0.3]))
    left = m.face_mask(0, 0)
    bc = bc_cls.from_masks([(left, 2.0), (m.face_mask(1, 1), -1.0)],
                           m.node_shape)
    return m, K, M, C, bc, left


@pytest.mark.parametrize("scheme,theta", [("ab1", 1.0), ("cnab2", 0.5),
                                          ("cnab2", 1.0)])
def test_run_transient_with_time_mod_and_convection(scheme, theta):
    """Both operands at once, made from one seed."""
    rng = np.random.default_rng(11)
    u0 = rng.standard_normal((8, 7))
    b = rng.standard_normal((8, 7))
    src_amp = rng.standard_normal((8, 7))
    out = []
    for pkg_mesh, pkg_asm, bc_cls, run, conf, extra in (
            (port_mesh, assembly, DirichletBC, timestepping.run_transient,
             config, {"device": "cpu"}),
            (ref_mesh, ref_asm, RefBC, ref_ts.run_transient, ref_config, {})):
        m, K, M, C, bc, left = _operands(pkg_mesh, pkg_asm, bc_cls)
        tm = {"omega": 5.0, "phase": 0.7, "source_amp": src_amp,
              "bc_amp_values": np.where(left, 1.5, 0.0)}
        with conf.config_overrides(**TRANSIENT, **extra):
            out.append(run(K, M, m, bc, b, np.asarray(bc.apply_values(u0)),
                           0.01, 5, theta=theta, C_np=C, time_mod=tm,
                           convection_scheme=scheme))
    r, r_ref = out
    assert np.array_equal(r.times, r_ref.times)
    assert r.values.shape == r_ref.values.shape == (6, 8, 7)
    assert abs(r.total_cg_iterations - r_ref.total_cg_iterations) <= 5
    assert np.abs(r.values - r_ref.values).max() \
        / np.abs(r_ref.values).max() <= 1e-6
    # the driven face follows g(t) at the new time level
    t = r.times[1:]
    assert np.allclose(r.values[1:, 0, 0],
                       2.0 + 1.5 * np.sin(5.0 * t + 0.7), atol=1e-6)


def test_run_transient_time_mod_without_amplitudes_changes_nothing():
    m, K, M, _, bc, _ = _operands(port_mesh, assembly, DirichletBC)
    u0 = np.asarray(bc.apply_values(np.ones((8, 7))))
    with config.config_overrides(device="cpu", **TRANSIENT):
        a = timestepping.run_transient(K, M, m, bc, np.zeros((8, 7)), u0,
                                       0.01, 3)
        b = timestepping.run_transient(K, M, m, bc, np.zeros((8, 7)), u0,
                                       0.01, 3, time_mod={"omega": 4.0})
    assert np.array_equal(a.values, b.values)


# ----------------------------------------------------------------------
# Closed forms and dense stepping, the port alone (the bounds of the JAX
# package's own tests of these families)
# ----------------------------------------------------------------------

def _linear_dirichlet_robin(kappa, L, T0, h, t_inf):
    """u(x) = T0 + c x / kappa with -kappa u'(L) = h (u(L) - t_inf)."""
    c = h * (t_inf - T0) / (1.0 + h * L / kappa)
    return lambda x: T0 + c * x / kappa


def _solve(p, **cfg):
    with config.config_overrides(device="cpu", **cfg):
        return heat.solve_heat_problem(p)


def test_1d_dirichlet_robin_exact():
    kappa, L, T0, h, t_inf = 2.5, 3.0, 100.0, 7.0, 25.0
    m = port_mesh.interval_mesh(32, 0.0, L)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         bc_pairs=[(m.face_mask(0, 0), T0)],
                         robin_faces=[(0, 1, h, t_inf)])
    _, values, info = _solve(p)
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(
        values[0], _linear_dirichlet_robin(kappa, L, T0, h, t_inf)(x),
        rtol=1e-8)
    assert info["converged"]


def test_1d_dirichlet_flux_exact():
    kappa, L, q = 4.0, 2.0, 50.0
    m = port_mesh.interval_mesh(16, 0.0, L)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         bc_pairs=[(m.face_mask(0, 0), 0.0)],
                         flux_faces=[(0, 1, q)])
    _, values, _ = _solve(p)
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], q * x / kappa, rtol=1e-8,
                               atol=1e-10)


def test_1d_pure_robin_no_dirichlet():
    kappa, L = 1.5, 2.0
    hl, tl, hr, tr = 3.0, 80.0, 6.0, 20.0
    a, c = np.linalg.solve(np.array([[hl, -kappa], [hr, kappa + hr * L]]),
                           np.array([hl * tl, hr * tr]))
    m = port_mesh.interval_mesh(24, 0.0, L)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         robin_faces=[(0, 0, hl, tl), (0, 1, hr, tr)])
    _, values, info = _solve(p)
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], a + c * x, rtol=1e-7)
    assert info["converged"]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("path", ["host LU", "device CG"])
def test_nd_dirichlet_robin_insulated_sides(dim, path):
    kappa, L, T0, h, t_inf = 1.2, 2.0, 60.0, 4.0, 10.0
    m = port_mesh.rectangle_mesh(12, 7, (0, 0), (L, 1.3)) if dim == 2 else \
        port_mesh.box_mesh(10, 5, 6, (0, 0, 0), (L, 0.8, 1.1))
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         bc_pairs=[(m.face_mask(0, 0), T0)],
                         robin_faces=[(0, 1, h, t_inf)])
    _, values, info = _solve(p, **({} if path == "host LU" else MIXED))
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(
        values[0], _linear_dirichlet_robin(kappa, L, T0, h, t_inf)(x),
        rtol=1e-7)
    assert info["converged"]


def test_3d_flux_plus_robin_combination():
    kappa, L, q_in, h, t_inf = 2.0, 1.5, 30.0, 5.0, 40.0
    m = port_mesh.box_mesh(8, 4, 4, (0, 0, 0), (L, 1.0, 1.0))
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         flux_faces=[(0, 0, q_in)],
                         robin_faces=[(0, 1, h, t_inf)])
    _, values, info = _solve(p)
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(
        values[0], t_inf + q_in / h + q_in * (L - x) / kappa, rtol=1e-7)
    assert info["converged"]


def test_1d_cylindrical_robin_weighted():
    kappa, r1, r2, T0, h, t_inf = 1.0, 0.5, 2.0, 100.0, 3.0, 20.0
    A, B = np.linalg.solve(
        np.array([[1.0, np.log(r1)], [h, h * np.log(r2) + kappa / r2]]),
        np.array([T0, h * t_inf]))
    m = port_mesh.interval_mesh(512, r1, r2)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, steady=True,
                         weight_fn=heat.weight_r,
                         bc_pairs=[(m.face_mask(0, 0), T0)],
                         robin_faces=[(0, 1, h, t_inf)])
    _, values, _ = _solve(p)
    r = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], A + B * np.log(r), rtol=2e-5)


def test_radial_mixed_sphere_dirichlet_robin_analytic(tmp_path):
    kappa, r1, r2, T0, h, t_inf = 2.0, 0.5, 1.5, 300.0, 8.0, 20.0
    A, B = np.linalg.solve(
        np.array([[1.0, 1.0 / r1], [h, h / r2 - kappa / r2 ** 2]]),
        np.array([T0, h * t_inf]))
    with config.config_overrides(device="cpu"):
        res = api.solve_heat_radial_mixed(
            kind="sphere", r_inner=r1, r_outer=r2, nr=400, diffusivity=kappa,
            steady=True, data_dir=str(tmp_path), boundary_conditions={
                "inner": T0,
                "outer": {"type": "robin", "h": h, "T_ambient": t_inf}})
    f = load_field(res.data_file)
    r = f.coords_array()[:, 0]
    np.testing.assert_allclose(f.values_array()[0], A + B / r, rtol=2e-5)
    assert f.meta["geometry_type"] == "shell"


def test_radial_mixed_solid_cylinder_quench_transient(tmp_path):
    with config.config_overrides(**CPU):
        res = api.solve_heat_radial_mixed(
            kind="cylinder", r_inner=0.0, r_outer=1.0, nr=64,
            T_initial=400.0, dt=0.02, num_steps=10, data_dir=str(tmp_path),
            boundary_conditions={"all": {"type": "robin", "h": 25.0,
                                         "T_ambient": 20.0}})
    v = load_field(res.data_file).values_array()
    means = v.mean(axis=1)
    assert np.all(np.diff(means) < 0) and v[-1].min() > 20.0
    assert v[-1][-1] < v[-1][0] and np.all(np.isfinite(v))


def test_transient_robin_matches_dense_backward_euler():
    m = port_mesh.rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    h, t_inf, dt, nsteps = 8.0, 25.0, 0.02, 12
    robin = [(0, 0, h, t_inf), (0, 1, h, t_inf), (1, 0, h, t_inf),
             (1, 1, h, t_inf)]
    p = heat.HeatProblem(mesh=m, T_initial=90.0, dt=dt, num_steps=nsteps,
                         theta=1.0, robin_faces=robin)
    _, values, _ = _solve(p, **TRANSIENT)
    K = assembly.assemble_scalar_stencil(m, "stiffness")
    b = np.zeros(m.node_shape)
    for axis, side, hh, tt in robin:
        K = surface.add_stencil(
            K, surface.assemble_face_mass(m, axis, side, coeff=hh))
        b += surface.assemble_face_load(m, axis, side, coeff=hh * tt)
    A = assembly.stencil_to_dense(m, K)
    M = assembly.stencil_to_dense(
        m, assembly.assemble_scalar_stencil(m, "mass"))
    u = np.full(m.num_nodes, 90.0)
    bf = port_mesh.flatten_values(b, 2)
    for _ in range(nsteps):
        u = np.linalg.solve(M + dt * A, M @ u + dt * bf)
    np.testing.assert_allclose(values[-1], u, rtol=1e-5, atol=1e-6)
    means = values.mean(axis=1)
    assert np.all(np.diff(means) < 0) and means[-1] > t_inf


def test_periodic_matches_dense_stepping():
    m = port_mesh.rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    kappa, dt, nsteps, theta = 0.4, 0.02, 9, 1.0
    omega, phase, amp_bc, amp_src = 3.0, 0.4, 7.0, 2.5
    left = m.face_mask(0, 0)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, T_initial=5.0, dt=dt,
                         num_steps=nsteps, theta=theta,
                         bc_pairs=[(left, 20.0)],
                         bc_amp_pairs=[(left, amp_bc)],
                         source_type="constant", source_value=1.0,
                         source_amp=amp_src, mod_omega=omega,
                         mod_phase=phase)
    _, values, info = _solve(p, **TRANSIENT)
    flat = port_mesh.flatten_values
    A = assembly.stencil_to_dense(m, {
        o: kappa * W for o, W in
        assembly.assemble_scalar_stencil(m, "stiffness").items()})
    M = assembly.stencil_to_dense(
        m, assembly.assemble_scalar_stencil(m, "mass"))
    load = flat(assembly.assemble_load(m), 2)
    bc = DirichletBC.from_masks([(left, 20.0)], m.node_shape)
    free = flat(np.asarray(bc.free_mask), 2).astype(bool)
    gflat = flat(np.asarray(bc.values), 2)
    g_amp = flat(np.where(left, amp_bc, 0.0), 2)
    u = np.where(free, 5.0, gflat)
    lhs = M + theta * dt * A
    for n in range(nsteps):
        s_n = np.sin(omega * n * dt + phase)
        s_np1 = np.sin(omega * (n + 1) * dt + phase)
        w = theta * s_np1 + (1 - theta) * s_n
        g_t = gflat + s_np1 * g_amp
        rhs = M @ u - (1 - theta) * dt * (A @ u) \
            + dt * (1.0 + amp_src * w) * load
        un = g_t.copy()
        un[free] = np.linalg.solve(
            lhs[np.ix_(free, free)],
            rhs[free] - lhs[np.ix_(free, ~free)] @ g_t[~free])
        u = un
    np.testing.assert_allclose(values[-1], u, rtol=2e-5, atol=1e-7)
    assert info["converged"]


def test_thermal_wave_analytic():
    """Semi-infinite solid with surface T = A sin(ωt): the quasi-steady
    response is A e^{-kx} sin(ωt − kx), k = sqrt(ω/2κ)."""
    kappa, omega, A = 1.0, 2.0 * np.pi, 10.0
    k = np.sqrt(omega / (2.0 * kappa))
    L, nx, nper, steps_per = 4.0, 512, 4, 256
    period = 2.0 * np.pi / omega
    m = port_mesh.interval_mesh(nx, 0.0, L)
    p = heat.HeatProblem(mesh=m, diffusivity=kappa, T_initial=0.0,
                         dt=period / steps_per, num_steps=nper * steps_per,
                         theta=0.5,
                         bc_pairs=[(m.face_mask(0, 0), 0.0),
                                   (m.face_mask(0, 1), 0.0)],
                         bc_amp_pairs=[(m.face_mask(0, 0), A)],
                         mod_omega=omega)
    times, values, info = _solve(p, precision="f32")
    x = m.flat_node_coords()[:, 0]
    exact = A * np.exp(-k * x) * np.sin(omega * times[-1] - k * x)
    zone = x < 2.5 / k
    assert np.max(np.abs(values[-1][zone] - exact[zone])) < 0.05 * A
    per_idx = [i for i, t in enumerate(times)
               if t > times[-1] - period - 1e-12]
    j = int(np.argmin(np.abs(k * x - 1.0)))
    amp_j = 0.5 * (values[per_idx, j].max() - values[per_idx, j].min())
    np.testing.assert_allclose(amp_j, A * np.exp(-1.0), rtol=0.08)
    assert info["converged"]


def test_radial_mixed_periodic_dirichlet(tmp_path):
    period, amp, base = 0.5, 5.0, 20.0
    with config.config_overrides(**CPU):
        res = api.solve_heat_radial_mixed(
            kind="cylinder", r_inner=0.5, r_outer=1.0, nr=96,
            diffusivity=0.05, T_initial=base, dt=period / 64, num_steps=256,
            data_dir=str(tmp_path), boundary_conditions={
                "outer": {"type": "dirichlet", "value": base,
                          "amplitude": amp, "period": period},
                "inner": {"type": "insulated"}})
    f = load_field(res.data_file)
    v, times = f.values_array(), np.asarray(f.times)
    # float32 frames: the bound is a few ulps of 25, not the 1e-6 of a
    # float64 scan
    np.testing.assert_allclose(
        v[1:, -1], base + amp * np.sin(2.0 * np.pi / period * times[1:]),
        atol=1e-5)
    last = times > times[-1] - period - 1e-12
    amp_mid = 0.5 * (v[last, 48].max() - v[last, 48].min())
    assert 0.0 < amp_mid < 0.8 * amp
    assert f.meta["boundary_conditions"]["outer"]["amplitude"] == amp


def _kirchhoff_T(theta, kappa0, beta):
    return (-1.0 + np.sqrt(1.0 + 2.0 * beta * theta / kappa0)) / beta


def test_1d_kirchhoff_exact():
    kappa0, beta, L, T0, T1 = 2.0, 0.01, 1.0, 100.0, 0.0
    m = port_mesh.interval_mesh(256, 0.0, L)
    p = heat.HeatProblem(mesh=m, steady=True, T_initial=50.0,
                         bc_pairs=[(m.face_mask(0, 0), T0),
                                   (m.face_mask(0, 1), T1)])
    with config.config_overrides(device="cpu"):
        _, values, info = heat.solve_heat_nonlinear(p, kappa0, beta)
    assert info["converged"] and info["picard_iterations"] < 40
    x = m.flat_node_coords()[:, 0]
    th0 = kappa0 * (T0 + beta * T0 ** 2 / 2)
    th1 = kappa0 * (T1 + beta * T1 ** 2 / 2)
    exact = _kirchhoff_T(th0 + (th1 - th0) * x / L, kappa0, beta)
    assert np.max(np.abs(values[0] - exact)) / max(abs(T0), abs(T1)) < 2e-4
    inner = (x > 0.1) & (x < 0.9)
    assert np.all(values[0][inner] > (T0 + (T1 - T0) * x / L)[inner])


def test_nonlinear_beta_zero_is_linear_and_2d_is_bounded():
    m = port_mesh.interval_mesh(64, 0.0, 2.0)
    p = heat.HeatProblem(mesh=m, steady=True,
                         bc_pairs=[(m.face_mask(0, 0), 30.0),
                                   (m.face_mask(0, 1), 10.0)])
    with config.config_overrides(device="cpu"):
        _, values, info = heat.solve_heat_nonlinear(p, 1.5, 1e-14)
    x = m.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], 30.0 - 10.0 * x, rtol=1e-8)
    assert info["picard_iterations"] <= 2
    m2 = port_mesh.rectangle_mesh(24, 24, (0, 0), (1.0, 1.0))
    p2 = heat.HeatProblem(
        mesh=m2, steady=True, T_initial=50.0,
        bc_builder=lambda mm: [(mm.boundary_mask(), 0.0),
                               (mm.face_mask(0, 0), 100.0)])
    with config.config_overrides(device="cpu"):
        _, v2, info2 = heat.solve_heat_nonlinear(p2, 1.0, 0.02)
    assert info2["converged"]
    assert v2[0].min() >= -1e-8 and v2[0].max() <= 100.0 + 1e-8


def _dense_advection(m, p, kappa, v):
    A = assembly.stencil_to_dense(m, {
        o: kappa * W for o, W in
        assembly.assemble_scalar_stencil(m, "stiffness").items()})
    M = assembly.stencil_to_dense(
        m, assembly.assemble_scalar_stencil(m, "mass"))
    C = assembly.stencil_to_dense(
        m, assembly.assemble_convection_stencil(m, v))
    bc = DirichletBC.from_masks([(m.boundary_mask(), 0.0)], m.node_shape)
    u = port_mesh.flatten_values(
        np.asarray(bc.apply_values(adv._initial_field(p))), 2)
    free = port_mesh.flatten_values(np.asarray(bc.free_mask),
                                    2).astype(bool)
    return A, M, C, u, free


@pytest.mark.parametrize("scheme,theta", [("ab1", 1.0), ("cnab2", 0.5)])
def test_imex_matches_dense_stepping(scheme, theta):
    """(M + θΔtK) u⁺ = (M − (1−θ)ΔtK) u − Δt·(C u, or its AB2 extrapolation
    with u⁻ seeded to u⁰)."""
    m = port_mesh.rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    kappa, v, dt, nsteps = 0.05, [0.8, -0.3], 0.01, 8
    p = adv.AdvectionProblem(mesh=m, velocity=v, diffusivity=kappa,
                             initial_type="gaussian",
                             pulse_center=(0.4, 0.6), pulse_width=0.15,
                             dt=dt, num_steps=nsteps, scheme=scheme,
                             theta=theta if scheme == "ab1" else None)
    with config.config_overrides(device="cpu", **TRANSIENT):
        _, values, info = adv.solve_advection_problem(p)
    assert info["scheme"] == scheme and info["converged"]
    A, M, C, u, free = _dense_advection(m, p, kappa, v)
    lhs = (M + theta * dt * A)[np.ix_(free, free)]
    rhs_op = M - (1 - theta) * dt * A
    u_prev = u.copy()
    for _ in range(nsteps):
        conv = C @ u if scheme == "ab1" else \
            1.5 * (C @ u) - 0.5 * (C @ u_prev)
        r = rhs_op @ u - dt * conv
        un = np.zeros_like(u)
        un[free] = np.linalg.solve(lhs, r[free])
        u_prev, u = u, un
    np.testing.assert_allclose(values[-1], u, rtol=2e-5, atol=1e-6)


def _advect_1d(m, nsteps, scheme, T, kappa, s0, x0):
    p = adv.AdvectionProblem(mesh=m, velocity=[1.0], diffusivity=kappa,
                             initial_type="gaussian", pulse_center=[x0],
                             pulse_width=s0, dt=T / nsteps,
                             num_steps=nsteps, theta=0.5, scheme=scheme)
    with config.config_overrides(**CPU):
        _, values, info = adv.solve_advection_problem(p)
    assert info["cfl"] < 1.0 and info["converged"]
    return values[-1]


def test_cnab2_second_order_in_dt():
    m = port_mesh.interval_mesh(128, 0.0, 3.0)
    args = (0.3, 0.005, 0.1, 0.7)
    ref = _advect_1d(m, 400, "cnab2", *args)
    e1 = np.linalg.norm(_advect_1d(m, 50, "cnab2", *args) - ref)
    e2 = np.linalg.norm(_advect_1d(m, 100, "cnab2", *args) - ref)
    assert e2 < 0.32 * e1, (e1, e2)
    ref1 = _advect_1d(m, 400, "ab1", *args)
    a1 = np.linalg.norm(_advect_1d(m, 50, "ab1", *args) - ref1)
    a2 = np.linalg.norm(_advect_1d(m, 100, "ab1", *args) - ref1)
    assert a2 > 0.38 * a1, (a1, a2)
    assert e1 < a1


def test_gaussian_transport_1d_analytic():
    kappa, v, s0, x0, T = 0.005, 1.0, 0.08, 0.7, 0.6
    m = port_mesh.interval_mesh(512, 0.0, 3.0)
    x = m.flat_node_coords()[:, 0]
    s2 = s0 ** 2 + 2 * kappa * T
    exact = (s0 / np.sqrt(s2)) * np.exp(-(x - x0 - v * T) ** 2 / (2 * s2))

    def err_at(nsteps):
        u = _advect_1d(m, nsteps, "ab1", T, kappa, s0, x0)
        assert abs(x[np.argmax(u)] - (x0 + v * T)) < 0.02
        return np.linalg.norm(u - exact) / np.linalg.norm(exact)

    e1, e2 = err_at(600), err_at(1200)
    assert e1 < 0.03, e1
    assert e2 < 0.65 * e1, (e1, e2)


def test_stability_diagnostics_reported():
    m = port_mesh.interval_mesh(64, 0.0, 1.0)
    p = adv.AdvectionProblem(mesh=m, velocity=[50.0], diffusivity=0.001,
                             initial_type="gaussian", dt=0.01, num_steps=2)
    with config.config_overrides(**CPU):
        _, _, info = adv.solve_advection_problem(p)
    assert info["cfl"] > 1.0 and info["cell_peclet"] > 2.0
    assert info["scheme"] == "cnab2"


# ----------------------------------------------------------------------
# The size gate of the constant-interior route
# ----------------------------------------------------------------------

def _spy_cs(monkeypatch):
    calls = []
    orig = ck.CSFlatStencilOperator.try_build.__func__

    def spy(cls, offsets, weights_np, node_shape, *a, **kw):
        calls.append(tuple(int(s) for s in node_shape))
        return orig(cls, offsets, weights_np, node_shape, *a, **kw)

    monkeypatch.setattr(ck.CSFlatStencilOperator, "try_build",
                        classmethod(spy))
    return calls


def _heat_system(cells):
    m = port_mesh.box_mesh(*cells, (0, 0, 0), (1.0, 0.5, 0.5))

    def make_level(mesh_c):
        A = timestepping._combine(
            assembly.assemble_scalar_stencil(mesh_c, "stiffness"),
            assembly.assemble_scalar_stencil(mesh_c, "mass"), 0.01, 1.0)
        return A, DirichletBC.from_masks([(mesh_c.boundary_mask(), 0.0)],
                                         mesh_c.node_shape)

    A, bc = make_level(m)
    return m, linsolve.prepare_system(A, m, bc, np.zeros(m.node_shape),
                                      1), make_level


@pytest.mark.parametrize("mode", ["1", "hybrid"])
def test_cs_route_only_at_and_above_its_size_gate(monkeypatch, mode):
    """A hierarchy whose levels straddle 65,536 DOF (65×33×33 = 70,785
    nodes, then 33×17×17 = 9,537 and below) keeps the constant-interior
    operator on the fine level only, as the JAX package's ``pallas_wins``
    does; the dense kernel keeps taking every level, and those levels,
    all under ``BF16_MIN_DOF``, smooth with their float32 weights."""
    assert ck.CS_MIN_DOF == 65536 and sk.KERNEL_MIN_DOF == 0
    monkeypatch.setenv("PDE_TPU_CS", mode)
    calls = _spy_cs(monkeypatch)
    m, sysm, make_level = _heat_system((64, 32, 32))
    h = mg.build_hierarchy(m, sysm, make_level, vdim=1, device="cpu")
    assert calls == [(65, 33, 33)]
    assert len(h.levels) >= 3
    assert isinstance(h.levels[0].weights, ck.CSFlatStencilOperator)
    assert mg.BF16_MIN_DOF == 65536
    for lv in h.levels[1:]:
        assert isinstance(lv.weights, sk.FlatStencilOperator)
        assert lv.w_lo is None and lv.w_smooth is lv.weights
    lo = h.levels[0].w_lo
    assert (lo is h.levels[0].weights) if mode == "1" else \
        isinstance(lo, sk.FlatStencilOperator)


def test_static_flat_op_follows_the_cs_size_gate(monkeypatch):
    monkeypatch.setenv("PDE_TPU_CS", "1")
    calls = _spy_cs(monkeypatch)
    m, sysm, _ = _heat_system((32, 16, 16))           # 9,537 nodes
    op = linsolve._static_flat_op(sysm, m, 1, "cpu")
    assert isinstance(op, sk.FlatStencilOperator) and calls == []
    monkeypatch.setattr(ck, "CS_MIN_DOF", 9537)       # at the gate: taken
    op = linsolve._static_flat_op(sysm, m, 1, "cpu")
    assert isinstance(op, ck.CSFlatStencilOperator)
    assert calls == [(33, 17, 17)]
    monkeypatch.setattr(ck, "CS_MIN_DOF", 9538)
    assert isinstance(linsolve._static_flat_op(sysm, m, 1, "cpu"),
                      sk.FlatStencilOperator)
    assert len(calls) == 1
    monkeypatch.setenv("PDE_TPU_CS", "0")
    monkeypatch.setattr(ck, "CS_MIN_DOF", 0)
    assert isinstance(linsolve._static_flat_op(sysm, m, 1, "cpu"),
                      sk.FlatStencilOperator)
    assert len(calls) == 1
