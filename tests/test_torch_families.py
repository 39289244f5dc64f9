"""The 1D/2D and curvilinear tool families and the ``_loaded`` elasticity
tools of the port against the JAX package, at small sizes: signatures,
meta, coordinates and values of all twelve tools, through the host-direct
path (≤1e-9) and the mixed path (MG + double-f32 F-cycle, f32 CG with f64
refinement; ≤1e-6), transients at θ = 1 and 0.5 (≤1e-6 at
``transient_inner_tol=1e-8``), the copied ``ops/surface.py``, the bar's
options and the traction and thermal branches of ``solve_elasticity_nd``.

Values are compared, not df2 iteration counts: the two packages may cross
the stopping tolerance one round apart."""

import inspect

import numpy as np
import pytest

from pde_solver_tpu import api as ref_api
from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.fields import load_field as ref_load
from pde_solver_tpu.models import elasticity as ref_elast
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import surface as ref_surface
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu.ops.linsolve import prepare_system as ref_prepare
from pde_solver_tpu.ops.pallas_kernels import CSFlatStencilOperator as RefCS
from pde_solver_tpu.ops.timestepping import _combine as ref_combine
from pde_solver_tpu_torch import api
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch import mesh as port_mesh
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models import heat
from pde_solver_tpu_torch.ops import assembly, surface
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.cs_kernels import CSFlatStencilOperator
from pde_solver_tpu_torch.ops.linsolve import prepare_system
from pde_solver_tpu_torch.ops.timestepping import _combine

TOOLS = ("solve_heat_1D", "solve_heat_2D", "solve_heat_1D_cylindrical",
         "solve_heat_1D_spherical", "solve_heat_2D_cylindrical",
         "solve_heat_2D_spherical", "solve_heat_3D_spherical",
         "solve_elasticity_1D_static", "solve_elasticity_2D_static",
         "solve_elasticity_1D_loaded", "solve_elasticity_2D_loaded",
         "solve_elasticity_3D_loaded")
# small sizes per heat tool (every other argument default)
HEAT = {"solve_heat_1D": dict(nx=24),
        "solve_heat_2D": dict(nx=8, ny=6),
        "solve_heat_1D_cylindrical": dict(nr=24),
        "solve_heat_1D_spherical": dict(nr=24),
        "solve_heat_2D_cylindrical": dict(nr=8, nz=6),
        "solve_heat_2D_spherical": dict(nr=8, ntheta=6),
        "solve_heat_3D_spherical": dict(nr=5, ntheta=4, nphi=4)}
# mixed path on small meshes: MG + the double-f32 F-cycle where the tool
# has a level builder, f32 CG + f64 refinement where it has none
MIXED = dict(precision="mixed", host_direct_threshold=0, mg_threshold=100)
TRANSIENT = dict(precision="f32", transient_inner_tol=1e-8)
PLATE = dict(Lx=1.0, Ly=0.5, nx=16, ny=8, E=70e9, nu=0.33)
LOADS_2D = {"right": {"type": "traction", "vector": [0.0, -1e6]},
            "top": {"type": "pressure", "value": 2e5}}
LOADS_3D = {"right": {"type": "force", "vector": [0.0, 0.0, -5e3]},
            "top": {"type": "pressure", "value": 1e5}}


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
    assert set(meta["solver_stats"]) == set(meta_ref["solver_stats"])
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


@pytest.mark.parametrize("tool", sorted(HEAT))
def test_steady_heat_host_direct_matches_reference(tool, tmp_path):
    kw = dict(HEAT[tool], steady=True, source_type="constant",
              source_value=3.0)
    _check(*_run(tool, tmp_path, {}, **kw), 1e-9)


@pytest.mark.parametrize("tool", ["solve_heat_2D", "solve_heat_2D_spherical"])
def test_steady_heat_mixed_matches_reference(tool, tmp_path):
    kw = dict(nx=16, ny=12) if tool == "solve_heat_2D" else \
        dict(nr=16, ntheta=12)
    kw.update(steady=True, source_type="constant", source_value=3.0)
    _check(*_run(tool, tmp_path, MIXED, **kw), 1e-6)


@pytest.mark.parametrize("theta", [1.0, 0.5])
@pytest.mark.parametrize("tool", sorted(HEAT))
def test_transient_heat_matches_reference(tool, theta, tmp_path):
    kw = dict(HEAT[tool], num_steps=4, dt=0.005)
    if tool == "solve_heat_1D":
        kw.update(initial_type="sine", initial_wavenumber=2.0)
    port, ref = _run(tool, tmp_path, dict(TRANSIENT, theta=theta), **kw)
    assert port[0].shape[0] == 5
    _check(port, ref, 1e-6)


@pytest.mark.parametrize("quantity", ["stress", "strain", "displacement"])
def test_bar_host_direct_matches_reference(quantity, tmp_path):
    kw = dict(L=2.0, nx=40, E=70e9, area=0.01, body_force=500.0,
              quantity=quantity)
    _check(*_run("solve_elasticity_1D_static", tmp_path, {}, **kw), 1e-9)
    kw = dict(kw, end_load=2e4)
    del kw["body_force"]
    _check(*_run("solve_elasticity_1D_loaded", tmp_path, {}, **kw), 1e-9)


def test_bar_mixed_matches_reference(tmp_path):
    kw = dict(L=2.0, nx=64, E=70e9, area=0.01, body_force=500.0)
    _check(*_run("solve_elasticity_1D_loaded", tmp_path, MIXED,
                 end_load=1e3, **kw), 1e-6)


@pytest.mark.parametrize("quantity", ["stress", "strain"])
@pytest.mark.parametrize("plane_stress", [True, False])
def test_plane_elasticity_host_direct_matches_reference(plane_stress, quantity,
                                                        tmp_path):
    kw = dict(PLATE, nx=10, ny=5, body_fy=-7.65e4, plane_stress=plane_stress,
              quantity=quantity)
    _check(*_run("solve_elasticity_2D_static", tmp_path, {}, **kw), 1e-9)


@pytest.mark.parametrize("plane_stress", [True, False])
def test_plane_elasticity_mixed_matches_reference(plane_stress, tmp_path):
    """Through MG and the double-f32 F-cycle at vdim=2 (the K1/K2 v2 path
    on the card)."""
    kw = dict(PLATE, body_fx=1e4, body_fy=-7.65e4, plane_stress=plane_stress)
    _check(*_run("solve_elasticity_2D_static", tmp_path, MIXED, **kw), 1e-6)


@pytest.mark.parametrize("cfg", [{}, MIXED], ids=["host_direct", "mixed"])
def test_loaded_2d_matches_reference(cfg, tmp_path):
    kw = dict(PLATE, loads=LOADS_2D, body_fy=-1e3, quantity="displacement")
    _check(*_run("solve_elasticity_2D_loaded", tmp_path, cfg, **kw),
           1e-9 if not cfg else 1e-6)


# the 3D mixed case solves by f32 CG + f64 refinement: the 3D F-cycle is
# held against the reference by tests/test_torch_slice.py, and its first
# jit compile in the reference costs ~20 s
@pytest.mark.parametrize("cfg", [{}, dict(MIXED, use_multigrid=False)],
                         ids=["host_direct", "mixed"])
def test_loaded_3d_matches_reference(cfg, tmp_path):
    kw = dict(Lx=1.0, Ly=0.25, Lz=0.25, nx=8, ny=4, nz=4, loads=LOADS_3D)
    _check(*_run("solve_elasticity_3D_loaded", tmp_path, cfg, **kw),
           1e-9 if not cfg else 1e-6)


def test_face_loads_resolve_as_reference():
    from pde_solver_tpu.api import _resolve_face_loads as ref_resolve

    loads = {"right": {"type": "force", "vector": [0.0, 3.0]},
             "y_max": {"type": "pressure", "value": 2.0},
             "sides": {"vector": [1.0, 0.0]}}
    mp = port_mesh.rectangle_mesh(4, 2, (0, 0), (2.0, 0.5))
    mr = ref_mesh.rectangle_mesh(4, 2, (0, 0), (2.0, 0.5))
    got, want = api._resolve_face_loads(loads, mp), ref_resolve(loads, mr)
    assert [(a, s) for a, s, _ in got] == [(a, s) for a, s, _ in want]
    for (_, _, t), (_, _, t_ref) in zip(got, want):
        assert np.array_equal(t, t_ref)
    with pytest.raises(ValueError):
        api._resolve_face_loads({"left": {"type": "moment"}}, mp)
    with pytest.raises(ValueError):
        heat._face_keys(2, "north")
    for dim, names in heat._FACE_NAMES.items():
        for name in list(names) + list(heat._FACE_ALIASES) + ["all", "sides"]:
            try:
                want_keys = ref_api.heat._face_keys(dim, name)
            except ValueError:
                with pytest.raises(ValueError):
                    heat._face_keys(dim, name)
                continue
            assert heat._face_keys(dim, name) == want_keys


# ---- the copied surface layer ------------------------------------------------

SURFACE_MESHES = {
    "interval9": lambda m: m.interval_mesh(9, 0.1, 1.0),
    "rect7x5": lambda m: m.rectangle_mesh(7, 5, (0.1, 0.0), (1.0, 2.0)),
    "box5x4x3": lambda m: m.box_mesh(5, 4, 3, (0.1, 0, 0), (1.0, 0.5, 0.75)),
}


@pytest.mark.parametrize("name", sorted(SURFACE_MESHES))
@pytest.mark.parametrize("weighted", [False, True])
def test_surface_bit_equal(name, weighted):
    mp, mr = SURFACE_MESHES[name](port_mesh), SURFACE_MESHES[name](ref_mesh)
    wfn = heat.weight_r if weighted else None
    for axis in range(mp.dim):
        for side in (0, 1):
            assert np.array_equal(
                surface.assemble_face_load(mp, axis, side, coeff=2.5,
                                           weight_fn=wfn),
                ref_surface.assemble_face_load(mr, axis, side, coeff=2.5,
                                               weight_fn=wfn))
            fp = surface.assemble_face_mass(mp, axis, side, coeff=0.7,
                                            weight_fn=wfn)
            fr = ref_surface.assemble_face_mass(mr, axis, side, coeff=0.7,
                                                weight_fn=wfn)
            assert sorted(fp) == sorted(fr)
            for off in fr:
                assert np.array_equal(fp[off], fr[off])
            Kp = assembly.assemble_scalar_stencil(mp, "stiffness")
            Kr = ref_asm.assemble_scalar_stencil(mr, "stiffness")
            sp, sr = surface.add_stencil(Kp, fp), ref_surface.add_stencil(Kr, fr)
            assert sorted(sp) == sorted(sr)
            for off in sr:
                assert np.array_equal(sp[off], sr[off])


# ---- the bar's options and solve_elasticity_nd's branches ------------------

def test_bar_refuses_end_load_with_clamp_both():
    for solve in (elast.solve_bar_1d, ref_elast.solve_bar_1d):
        with pytest.raises(ValueError, match="clamp_both"):
            solve(1.0, 8, 210e9, 1.0, 0.0, end_load=1e3, clamp_both=True)


@pytest.mark.parametrize("clamp_both", [False, True])
def test_bar_thermal_matches_reference(clamp_both):
    kw = dict(alpha=1.2e-5, delta_T=40.0, clamp_both=clamp_both)
    x, v, st = elast.solve_bar_1d(1.5, 30, 200e9, 0.02, 100.0, **kw,
                                  config=config.SolverConfig(device="cpu"))
    x_r, v_r, st_r = ref_elast.solve_bar_1d(1.5, 30, 200e9, 0.02, 100.0, **kw)
    assert set(st) == set(st_r) and st["converged"]
    assert np.array_equal(x, x_r)
    assert np.abs(v - v_r).max() <= 1e-9 * np.abs(v_r).max()
    if clamp_both:  # constrained bar, no body force term at the ends
        assert np.isclose(v[len(v) // 2], -200e9 * 1.2e-5 * 40.0, rtol=1e-2)


@pytest.mark.parametrize("dT", ["uniform", "field"])
@pytest.mark.parametrize("mode", ["plane_stress", "plane_strain", "3d"])
def test_thermal_and_traction_branches_match_reference(mode, dT):
    dims = (8, 4) if mode != "3d" else (6, 3, 3)
    make = (lambda m: m.rectangle_mesh(*dims, (0, 0), (1.0, 0.5))) \
        if mode != "3d" else \
        (lambda m: m.box_mesh(*dims, (0, 0, 0), (1.0, 0.5, 0.5)))
    mp, mr = make(port_mesh), make(ref_mesh)
    d = mp.dim
    if dT == "uniform":
        dTv = 25.0
    else:
        rng = np.random.default_rng(11)
        dTv = rng.uniform(0.0, 50.0, mp.node_shape)
    tractions = [(0, 1, np.array([2e5, -1e6, 3e5][:d])),
                 (1, 1, np.array([0.0, -4e5, 0.0][:d]))]
    body = np.array([0.0, -7.65e4, 0.0][:d])
    for quantity in ("stress", "strain"):
        kw = dict(quantity=quantity, traction_faces=tractions,
                  thermal=(1.2e-5, dTv), clamp_both=(dT == "field"))
        v, st = elast.solve_elasticity_nd(
            mp, 70e9, 0.33, body, mode, **kw,
            config=config.SolverConfig(device="cpu"))
        v_r, st_r = ref_elast.solve_elasticity_nd(mr, 70e9, 0.33, body, mode,
                                                  **kw)
        assert set(st) == set(st_r) and st["converged"]
        assert np.abs(v - v_r).max() <= 1e-9 * np.abs(v_r).max()


# ---- why K3/K4 stay off the 1D/2D path --------------------------------------

@pytest.mark.parametrize("kind", ["heat", "plane_stress"])
@pytest.mark.parametrize("cells", [(32, 32), (64, 48)])
def test_constant_interior_refuses_2d_operators(kind, cells):
    """Both packages' constant-interior build refuses the slice's 2D
    operators, so ``PDE_TPU_CS`` leaves the 1D/2D tools on K1/K2."""
    built = []
    for m, asm, prep, bc_cls, combine, build in (
            (port_mesh, assembly, prepare_system, DirichletBC, _combine,
             lambda *a: CSFlatStencilOperator.try_build(*a, device="cpu")),
            (ref_mesh, ref_asm, ref_prepare, RefBC, ref_combine,
             lambda *a: RefCS.try_build(*a, interpret=True))):
        mesh = m.rectangle_mesh(*cells, (0, 0), (1.0, 1.0))
        if kind == "heat":
            K = asm.assemble_scalar_stencil(mesh, "stiffness")
            M = asm.assemble_scalar_stencil(mesh, "mass")
            bc = bc_cls.from_masks([(mesh.boundary_mask(), 0.0)],
                                   mesh.node_shape)
            sysm = prep(combine(K, M, 0.01, 1.0), mesh, bc,
                        np.zeros(mesh.node_shape), 1)
            v = 1
        else:
            lam, mu = elast.lame_parameters(70e9, 0.33, "plane_stress")
            K = asm.assemble_elasticity_stencil(mesh, lam, mu)
            bc = bc_cls.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                   mesh.node_shape, vdim=2)
            sysm = prep(K, mesh, bc, np.zeros(mesh.node_shape + (2,)), 2)
            v = 2
        built.append(build(sysm.offsets, sysm.weights, mesh.node_shape, v))
    assert built == [None, None]
    one_d = port_mesh.interval_mesh(64, 0.0, 1.0)
    K = assembly.assemble_scalar_stencil(one_d, "stiffness")
    assert CSFlatStencilOperator.try_build(
        tuple(sorted(K)), [K[o] for o in sorted(K)], one_d.node_shape,
        device="cpu") is None
