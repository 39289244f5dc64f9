"""Public solver API of the port — the tools ported so far: heat 1D, 2D
and 3D, the four ``_mixed`` heat tools (Robin, flux and periodically driven
faces), the two nonlinear-conductivity tools, advection-diffusion 1D, 2D
and 3D, the five curvilinear heat tools, static elasticity 1D, 2D and 3D,
the three ``_loaded`` elasticity tools, 2D and 3D modal analysis, 3D
elastodynamics, the wave equation 1D, 2D and 3D (Newmark-β), and the two
plot tools (host numpy/scipy, ``pde_solver_tpu_torch.viz``): all 31.

Names, signatures, defaults, artifact layout and result metadata match
``pde_solver_tpu.api`` exactly (tests compare ``inspect.signature``).  Every
``SolveResult.meta`` carries a ``solver_stats`` block (DOF count, CG
iterations, achieved residual, and the request's span seconds and
counters, ``utils.observability``).

The device and precision come from ``config.get_config()`` (scope them with
``config.config_overrides``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pde_solver_tpu_torch.fields import (PlotResult, SolveResult,
                                         TimeSeriesField, save_field)
from pde_solver_tpu_torch.mesh import (StructuredMesh, box_mesh,
                                       flatten_values, interval_mesh,
                                       rectangle_mesh)
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models import heat, wave
from pde_solver_tpu_torch.models.heat import (
    embed_identity3, embed_line, embed_plane, embed_rtheta, embed_rz,
    embed_spherical, weight_r, weight_r2, weight_r2_sin_theta, weight_r_yz,
)
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.eigen import smallest_modes
from pde_solver_tpu_torch.utils.observability import request


def _pack(mesh: StructuredMesh, embed, times, values, dim, meta, stats) -> TimeSeriesField:
    coords = embed(mesh.flat_node_coords())
    meta = dict(meta)
    meta["solver_stats"] = stats
    return TimeSeriesField(coords=coords, values=np.asarray(values),
                           times=np.asarray(times), dim=dim, meta=meta)


def _result(field: TimeSeriesField, data_dir: str, prefix: str) -> SolveResult:
    path = save_field(field, data_dir, prefix)
    return SolveResult(data_file=path, dim=field.dim, meta=field.meta)


def _bar_result(x, values, meta, data_dir: str, prefix: str) -> SolveResult:
    """A 1D bar's single frame on its axis coordinates (meta as given)."""
    coords = np.zeros((len(x), 3))
    coords[:, 0] = x
    field = TimeSeriesField(coords=coords, values=values[None, :],
                            times=np.array([0.0]), dim=1, meta=meta)
    return _result(field, data_dir, prefix)


def _bar_name_unit(quantity: str):
    if quantity == "displacement":
        # extension: the axial displacement itself (unit m) — the
        # reference clamps quantity to stress|strain
        return "axial_displacement", "m"
    if quantity == "strain":
        return "axial_strain", "-"
    return "axial_stress", "Pa"


def _von_mises_name_unit(quantity: str):
    if quantity == "displacement":
        # extension: |u| per node (unit m) — the reference clamps
        # quantity to stress|strain
        return "displacement_magnitude", "m"
    if quantity == "strain":
        return "von_mises_strain", "-"
    return "von_mises_stress", "Pa"


def _radial_bcs(r_inner: float, T_inner: float, T_outer: float):
    """Dirichlet ends of a 1D radial tool; no inner condition on a solid
    cylinder or sphere (r_inner = 0)."""
    def bc_builder(m):
        pairs = []
        if r_inner > 1e-10:
            pairs.append((m.face_mask(0, 0), T_inner))
        pairs.append((m.face_mask(0, 1), T_outer))
        return pairs
    return bc_builder


# ======================================================================
# Heat — Cartesian
# ======================================================================

def solve_heat_1D(
    length: float = 2.0,
    nx: int = 50,
    diffusivity: float = 1.0,
    T_left: float = 20.0,
    T_right: float = 0.0,
    T_initial: float = 0.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
) -> SolveResult:
    """1D heat equation u_t − k u_xx = f on (0, length); Dirichlet ends.

    Reference tool: fenics_mcp_server.py:1902-1974 (same defaults/meta).
    """
    mesh = interval_mesh(nx, 0.0, length)
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity,
        bc_builder=lambda m: [(m.face_mask(0, 0), T_left),
                              (m.face_mask(0, 1), T_right)],
        source_type=source_type, source_value=source_value, steady=steady,
        T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, initial_wavenumber=initial_wavenumber,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "length": length,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "heat_1d")


def solve_heat_2D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 30,
    ny: int = 30,
    diffusivity: float = 1.0,
    T_boundary: float = 0.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
) -> SolveResult:
    """2D heat on [0,Lx]×[0,Ly], uniform Dirichlet boundary.

    Reference tool: fenics_mcp_server.py:1977-2041.
    """
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity,
        bc_builder=lambda m: [(m.boundary_mask(), T_boundary)],
        source_type=source_type, source_value=source_value, steady=steady,
        T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, initial_wavenumber=initial_wavenumber,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_plane, times, values, 2, meta, stats)
    return _result(field, data_dir, "heat_2d")


def solve_heat_3D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    diffusivity: float = 1.0,
    T_boundary: float = 0.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 20,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
    geometry_type: str = "box",
    cylinder_radius: Optional[float] = None,
    T_left: Optional[float] = None,
    T_right: Optional[float] = None,
    T_side: Optional[float] = None,
    core_radius: Optional[float] = None,
    core_diffusivity: Optional[float] = None,
) -> SolveResult:
    """3D heat: box [0,Lx]×[0,Ly]×[0,Lz] or cylinder (radius, length Lx along x).

    Supports uniform (T_boundary) or directional (T_left/T_right/T_side) BCs
    and a high-conductivity core (core_radius + core_diffusivity).
    Reference tool: fenics_mcp_server.py:2122-2213; raw solver :475-762.
    The cylinder uses the structured box-embedding with r-weighted forms —
    the reference's own fallback discretization (:524-530, :639-647).
    """
    is_cyl = geometry_type == "cylinder" and cylinder_radius is not None
    if is_cyl:
        R = float(cylinder_radius)
        # Mesh resolution mapping mirrors the reference fallback (:527-529).
        mesh = box_mesh(nx, max(1, int(ny * R * 2)), max(1, int(nz * R * 2)),
                        (0.0, -R, -R), (Lx, R, R))
        wfn = weight_r_yz
    else:
        mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
        wfn = None

    has_composite = core_radius is not None and core_diffusivity is not None
    kappa_builder = None
    if has_composite:
        # Mesh-parametric marking (re-run per MG level) instead of a fixed
        # per-cell array — enables geometric multigrid for composite solves.
        def kappa_builder(m):
            return heat.composite_kappa_cells(
                m, float(core_radius), float(diffusivity),
                float(core_diffusivity))

    use_directional = T_left is not None or T_right is not None or T_side is not None

    def bc_builder(m):
        if not use_directional:
            return [(m.boundary_mask(), T_boundary)]
        pairs = []
        if T_left is not None:
            pairs.append((m.face_mask(0, 0), float(T_left)))
        if T_right is not None:
            pairs.append((m.face_mask(0, 1), float(T_right)))
        if T_side is not None:
            if is_cyl:
                from pde_solver_tpu_torch.ops.bc import radius_shell
                pairs.append((radius_shell(m, (1, 2), R, exclude_axis_faces=0),
                              float(T_side)))
            else:
                from pde_solver_tpu_torch.ops.bc import boundary_except_faces
                pairs.append((boundary_except_faces(m, 0), float(T_side)))
        return pairs

    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=wfn, weight_quad_degree=4,
        kappa_builder=kappa_builder, bc_builder=bc_builder,
        source_type=source_type, source_value=source_value, steady=steady,
        T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, initial_wavenumber=initial_wavenumber,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)

    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian" if geometry_type == "box" else "cylindrical",
        "Lx": Lx,
        "Ly": Ly if geometry_type == "box" else (cylinder_radius * 2 if cylinder_radius else Ly),
        "Lz": Lz if geometry_type == "box" else (cylinder_radius * 2 if cylinder_radius else Lz),
        "geometry_type": geometry_type,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    if is_cyl:
        meta["cylinder_radius"] = float(cylinder_radius)
    if use_directional:
        if T_left is not None:
            meta["T_left"] = T_left
        if T_right is not None:
            meta["T_right"] = T_right
        if T_side is not None:
            meta["T_side"] = T_side
    else:
        meta["T_boundary"] = T_boundary
    if has_composite:
        meta["core_radius"] = core_radius
        meta["core_diffusivity"] = core_diffusivity
        meta["base_diffusivity"] = diffusivity
    else:
        meta["diffusivity"] = diffusivity

    field = _pack(mesh, embed_identity3, times, values, 3, meta, stats)
    return _result(field, data_dir, "heat_3d")


# ======================================================================
# Heat — mixed boundary conditions (extension tools)
# ======================================================================
# Beyond the reference surface (its heat solvers are Dirichlet-only,
# fenics_mcp_server.py:294-297): per-face Dirichlet / Robin-convective /
# Neumann-flux / insulated conditions.  The 13 reference tool signatures are
# a frozen contract (tests/test_api.py), so these live as *_mixed extensions.

def _mixed_heat_problem(mesh, dim, diffusivity, boundary_conditions,
                        source_type, source_value, steady, T_initial,
                        initial_type, initial_amplitude, initial_wavenumber,
                        dt, num_steps):
    dirichlet, robin, flux, modulated = heat.parse_face_bcs(
        boundary_conditions, dim)

    def bc_builder(m):
        return [(m.face_mask(axis, side), val)
                for axis, side, val in dirichlet]

    # sinusoidal Dirichlet driving: one shared (omega, phase) sinusoid —
    # the first modulated face sets it (mixed periods are not supported)
    bc_amp_pairs, mod_omega, mod_phase = (), 0.0, 0.0
    if modulated and not steady:
        mod_omega, mod_phase = modulated[0][3], modulated[0][4]
        bc_amp_pairs = [(mesh.face_mask(axis, side), amp)
                        for axis, side, amp, _, _ in modulated]

    return heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, bc_builder=bc_builder,
        robin_faces=robin, flux_faces=flux,
        bc_amp_pairs=bc_amp_pairs, mod_omega=mod_omega,
        mod_phase=mod_phase,
        source_type=source_type, source_value=source_value, steady=steady,
        T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude,
        initial_wavenumber=initial_wavenumber, dt=dt, num_steps=num_steps)


def _mixed_bc_meta(boundary_conditions):
    out = {}
    for face, spec in (boundary_conditions or {}).items():
        out[str(face)] = spec if isinstance(spec, dict) else float(spec)
    return out


def solve_heat_1D_mixed(
    length: float = 2.0,
    nx: int = 50,
    diffusivity: float = 1.0,
    boundary_conditions: Optional[dict] = None,
    T_initial: float = 0.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
) -> SolveResult:
    """1D heat with per-face mixed BCs (extension tool).

    ``boundary_conditions``: {"left"/"right": spec} where spec is a number
    (Dirichlet), {"type": "robin", "h": .., "T_ambient": ..} (convective
    -k du/dn = h (u - T_ambient)), {"type": "neumann", "flux": ..} (inward
    flux), or {"type": "insulated"}.  Unnamed faces are insulated.
    """
    mesh = interval_mesh(nx, 0.0, length)
    p = _mixed_heat_problem(mesh, 1, diffusivity, boundary_conditions,
                            source_type, source_value, steady, T_initial,
                            initial_type, initial_amplitude,
                            initial_wavenumber, dt, num_steps)
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "length": length,
        "boundary_conditions": _mixed_bc_meta(boundary_conditions),
        "source_type": source_type, "source_value": source_value,
        "steady": steady,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "heat_1d_mixed")


def solve_heat_2D_mixed(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 30,
    ny: int = 30,
    diffusivity: float = 1.0,
    boundary_conditions: Optional[dict] = None,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
) -> SolveResult:
    """2D heat on [0,Lx]×[0,Ly] with per-face mixed BCs (extension tool).

    Faces: left/right (x), bottom/top (y); see :func:`solve_heat_1D_mixed`
    for the spec format.
    """
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    p = _mixed_heat_problem(mesh, 2, diffusivity, boundary_conditions,
                            source_type, source_value, steady, T_initial,
                            initial_type, initial_amplitude,
                            initial_wavenumber, dt, num_steps)
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly,
        "boundary_conditions": _mixed_bc_meta(boundary_conditions),
        "source_type": source_type, "source_value": source_value,
        "steady": steady,
    }
    field = _pack(mesh, embed_plane, times, values, 2, meta, stats)
    return _result(field, data_dir, "heat_2d_mixed")


def solve_heat_3D_mixed(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    diffusivity: float = 1.0,
    boundary_conditions: Optional[dict] = None,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 20,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
    initial_wavenumber: float = 1.0,
) -> SolveResult:
    """3D heat on a box with per-face mixed BCs (extension tool).

    Faces: left/right (x), front/back (y), bottom/top (z), plus the groups
    "sides" (all non-x faces) and "all"; see :func:`solve_heat_1D_mixed`.
    """
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    p = _mixed_heat_problem(mesh, 3, diffusivity, boundary_conditions,
                            source_type, source_value, steady, T_initial,
                            initial_type, initial_amplitude,
                            initial_wavenumber, dt, num_steps)
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly, "Lz": Lz,
        "geometry_type": "box",
        "boundary_conditions": _mixed_bc_meta(boundary_conditions),
        "source_type": source_type, "source_value": source_value,
        "steady": steady,
    }
    field = _pack(mesh, embed_identity3, times, values, 3, meta, stats)
    return _result(field, data_dir, "heat_3d_mixed")


def solve_heat_radial_mixed(
    kind: str = "cylinder",
    r_inner: float = 0.0,
    r_outer: float = 1.0,
    nr: int = 50,
    diffusivity: float = 1.0,
    boundary_conditions: Optional[dict] = None,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
) -> SolveResult:
    """Radial cylindrical/spherical heat with mixed inner/outer BCs
    (extension tool — convective quenching is the canonical use).

    ``boundary_conditions``: {"inner"/"outer": spec} with the same spec
    format as :func:`solve_heat_1D_mixed` ("all"/"surface" apply to the
    outer face, plus the inner face of a hollow shell).  The Robin surface
    term carries the coordinate weight (r or r²), so the convective flux
    balance holds on the physical curved surface.  An unconstrained face is
    insulated; the r=0 axis of a solid body needs no condition (weight → 0).
    A Dirichlet spec may add ``amplitude`` + ``period`` (or ``omega``)
    [+ ``phase``] for sinusoidal driving T(t) = value + amplitude·sin(ωt+φ)
    — e.g. a daily surface-temperature cycle on a buried pipe.
    """
    if kind not in ("cylinder", "sphere"):
        raise ValueError(f"kind must be 'cylinder' or 'sphere', got {kind!r}")
    wfn = heat.weight_r if kind == "cylinder" else heat.weight_r2
    mesh = interval_mesh(nr, r_inner, r_outer)
    hollow = r_inner > 1e-10

    dirichlet, robin, flux, modulated = [], [], [], []
    for face, spec in (boundary_conditions or {}).items():
        f = str(face).strip().lower()
        if f in ("all", "boundary", "surface", "outer surface", "everywhere"):
            sides = [1] + ([0] if hollow else [])
        elif f in ("outer", "outside", "right"):
            sides = [1]
        elif f in ("inner", "inside", "left"):
            if not hollow:
                continue  # solid body: r=0 is an axis, not a surface
            sides = [0]
        else:
            raise ValueError(f"unknown radial face {face!r}; "
                             "expected inner/outer/all")
        if isinstance(spec, (int, float)):
            spec = {"type": "dirichlet", "value": float(spec)}
        kind_bc = str(spec.get("type", "dirichlet")).strip().lower()
        for side in sides:
            if kind_bc in ("dirichlet", "fixed", "temperature"):
                dirichlet.append((side, float(spec.get("value", 0.0))))
                if spec.get("amplitude"):
                    omega = spec.get("omega")
                    if omega is None:
                        period = float(spec.get("period", 1.0))
                        omega = 2.0 * np.pi / period if period else 0.0
                    modulated.append((side, float(spec["amplitude"]),
                                      float(omega),
                                      float(spec.get("phase", 0.0))))
            elif kind_bc in ("robin", "convection", "convective"):
                t_inf = spec.get("T_ambient", spec.get("t_ambient",
                         spec.get("t_inf", spec.get("ambient", 0.0))))
                robin.append((0, side, float(spec.get("h", 1.0)),
                              float(t_inf)))
            elif kind_bc in ("neumann", "flux", "heat_flux"):
                flux.append((0, side,
                             float(spec.get("flux", spec.get("value", 0.0)))))
            elif kind_bc in ("insulated", "adiabatic", "natural"):
                pass
            else:
                raise ValueError(f"unknown BC type {kind_bc!r}")

    def bc_builder(m):
        return [(m.face_mask(0, side), val) for side, val in dirichlet]

    # sinusoidal Dirichlet driving: one shared (omega, phase) sinusoid —
    # the first modulated face sets it (matching _mixed_heat_problem)
    bc_amp_pairs, mod_omega, mod_phase = (), 0.0, 0.0
    if modulated and not steady:
        mod_omega, mod_phase = modulated[0][2], modulated[0][3]
        bc_amp_pairs = [(mesh.face_mask(0, side), amp)
                        for side, amp, _, _ in modulated]

    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=wfn,
        weight_quad_degree=3 if kind == "cylinder" else 4,
        bc_builder=bc_builder, robin_faces=robin, flux_faces=flux,
        bc_amp_pairs=bc_amp_pairs, mod_omega=mod_omega, mod_phase=mod_phase,
        source_type=source_type, source_value=source_value, steady=steady,
        T_initial=T_initial, curvilinear_ic=True, dt=dt, num_steps=num_steps)
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cylindrical" if kind == "cylinder" else "spherical",
        "geometry_type": (kind if not hollow
                          else ("annulus" if kind == "cylinder" else "shell")),
        "r_inner": r_inner, "r_outer": r_outer,
        "boundary_conditions": _mixed_bc_meta(boundary_conditions),
        "source_type": source_type, "source_value": source_value,
        "steady": steady,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, f"heat_radial_{kind}_mixed")


# ======================================================================
# Nonlinear conductivity (extension tools)
# ======================================================================

def solve_heat_1D_nonlinear(
    length: float = 2.0,
    nx: int = 100,
    kappa0: float = 1.0,
    beta: float = 0.01,
    T_left: float = 100.0,
    T_right: float = 0.0,
    T_initial: float = 50.0,
    source_type: str = "none",
    source_value: float = 0.0,
    data_dir: str = "data",
) -> SolveResult:
    """Steady 1D heat with κ(T) = κ0(1+βT), Picard-iterated (extension
    tool — the reference's solvers are linear-only).  Validated against
    the Kirchhoff-transform closed form."""
    mesh = interval_mesh(nx, 0.0, length)
    p = heat.HeatProblem(
        mesh=mesh, steady=True, T_initial=T_initial,
        bc_builder=lambda m: [(m.face_mask(0, 0), T_left),
                              (m.face_mask(0, 1), T_right)],
        source_type=source_type, source_value=source_value)
    times, values, stats = heat.solve_heat_nonlinear(p, kappa0, beta)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "length": length,
        "kappa0": kappa0, "beta": beta, "nonlinear": True,
        "source_type": source_type, "source_value": source_value,
        "steady": True,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "heat_1d_nonlinear")


def solve_heat_2D_nonlinear(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 40,
    ny: int = 40,
    kappa0: float = 1.0,
    beta: float = 0.01,
    T_boundary: float = 0.0,
    T_left: Optional[float] = None,
    T_initial: float = 50.0,
    source_type: str = "none",
    source_value: float = 0.0,
    data_dir: str = "data",
) -> SolveResult:
    """Steady 2D heat with κ(T) = κ0(1+βT) (extension tool).  ``T_left``
    optionally overrides the uniform boundary on the x=0 edge."""
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))

    def bc_builder(m):
        pairs = [(m.boundary_mask(), T_boundary)]
        if T_left is not None:
            pairs.append((m.face_mask(0, 0), float(T_left)))
        return pairs

    p = heat.HeatProblem(mesh=mesh, steady=True, T_initial=T_initial,
                         bc_builder=bc_builder,
                         source_type=source_type,
                         source_value=source_value)
    times, values, stats = heat.solve_heat_nonlinear(p, kappa0, beta)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly,
        "kappa0": kappa0, "beta": beta, "nonlinear": True,
        "source_type": source_type, "source_value": source_value,
        "steady": True,
    }
    field = _pack(mesh, embed_plane, times, values, 2, meta, stats)
    return _result(field, data_dir, "heat_2d_nonlinear")


# ======================================================================
# Advection-diffusion (extension tools)
# ======================================================================
# The reference's schema lists pde_type="advection" and its parser emits it
# (pde_schema.py:15), but its dispatcher has no route — every advection
# query errors out.  These tools solve u_t + v·∇u = κΔu + f with IMEX
# θ-stepping (implicit SPD diffusion, explicit Galerkin convection).

def _advection_solve(mesh, embed, dim, velocity, diffusivity, T_boundary,
                     T_initial, initial_type, pulse_center, pulse_width,
                     pulse_amplitude, source_type, source_value, dt,
                     num_steps, data_dir, extra_meta, scheme="cnab2"):
    from pde_solver_tpu_torch.models.advection import (AdvectionProblem,
                                                 solve_advection_problem)
    p = AdvectionProblem(
        mesh=mesh, velocity=velocity, diffusivity=diffusivity,
        bc_builder=lambda m: [(m.boundary_mask(), T_boundary)],
        source_type=source_type, source_value=source_value,
        T_initial=T_initial, initial_type=initial_type,
        pulse_center=pulse_center, pulse_width=pulse_width,
        pulse_amplitude=pulse_amplitude, dt=dt, num_steps=num_steps,
        scheme=scheme)
    times, values, stats = solve_advection_problem(p)
    meta = {
        "name": "concentration", "unit": "-", "pde": "advection",
        "coordinate_system": "cartesian",
        "velocity": list(np.asarray(velocity, dtype=float).ravel()),
        "diffusivity": diffusivity,
        "cfl": stats["cfl"], "cell_peclet": stats["cell_peclet"],
        "scheme": stats["scheme"],
        "source_type": source_type, "source_value": source_value,
        "steady": False, **extra_meta,
    }
    field = _pack(mesh, embed, times, values, dim, meta, stats)
    return _result(field, data_dir, f"advection_{dim}d")


def solve_advection_1D(
    length: float = 2.0,
    nx: int = 200,
    velocity: float = 1.0,
    diffusivity: float = 0.01,
    T_boundary: float = 0.0,
    T_initial: float = 0.0,
    initial_type: str = "gaussian",
    pulse_center: Optional[float] = None,
    pulse_width: float = 0.1,
    pulse_amplitude: float = 1.0,
    dt: float = 0.002,
    num_steps: int = 200,
    data_dir: str = "data",
    source_type: str = "none",
    source_value: float = 0.0,
    scheme: str = "cnab2",
) -> SolveResult:
    """1D advection-diffusion u_t + v u_x = κ u_xx + f on (0, length)
    (extension tool — see the module note above)."""
    mesh = interval_mesh(nx, 0.0, length)
    return _advection_solve(
        mesh, embed_line, 1, [velocity], diffusivity, T_boundary, T_initial,
        initial_type, None if pulse_center is None else [pulse_center],
        pulse_width, pulse_amplitude, source_type, source_value, dt,
        num_steps, data_dir, {"length": length}, scheme=scheme)


def solve_advection_2D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 60,
    ny: int = 60,
    vx: float = 1.0,
    vy: float = 0.0,
    diffusivity: float = 0.01,
    T_boundary: float = 0.0,
    T_initial: float = 0.0,
    initial_type: str = "gaussian",
    pulse_center_x: Optional[float] = None,
    pulse_center_y: Optional[float] = None,
    pulse_width: float = 0.1,
    pulse_amplitude: float = 1.0,
    dt: float = 0.002,
    num_steps: int = 200,
    data_dir: str = "data",
    source_type: str = "none",
    source_value: float = 0.0,
    scheme: str = "cnab2",
) -> SolveResult:
    """2D advection-diffusion on [0,Lx]×[0,Ly] (extension tool)."""
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    center = None
    if pulse_center_x is not None or pulse_center_y is not None:
        center = [pulse_center_x if pulse_center_x is not None else Lx / 2,
                  pulse_center_y if pulse_center_y is not None else Ly / 2]
    return _advection_solve(
        mesh, embed_plane, 2, [vx, vy], diffusivity, T_boundary, T_initial,
        initial_type, center, pulse_width, pulse_amplitude, source_type,
        source_value, dt, num_steps, data_dir, {"Lx": Lx, "Ly": Ly},
        scheme=scheme)


def solve_advection_3D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 24,
    ny: int = 24,
    nz: int = 24,
    vx: float = 1.0,
    vy: float = 0.0,
    vz: float = 0.0,
    diffusivity: float = 0.01,
    T_boundary: float = 0.0,
    T_initial: float = 0.0,
    initial_type: str = "gaussian",
    pulse_width: float = 0.15,
    pulse_amplitude: float = 1.0,
    dt: float = 0.005,
    num_steps: int = 100,
    data_dir: str = "data",
    source_type: str = "none",
    source_value: float = 0.0,
    scheme: str = "cnab2",
) -> SolveResult:
    """3D advection-diffusion on a box (extension tool)."""
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    return _advection_solve(
        mesh, embed_identity3, 3, [vx, vy, vz], diffusivity, T_boundary,
        T_initial, initial_type, None, pulse_width, pulse_amplitude,
        source_type, source_value, dt, num_steps, data_dir,
        {"Lx": Lx, "Ly": Ly, "Lz": Lz}, scheme=scheme)


# ======================================================================
# Heat — curvilinear
# ======================================================================

def solve_heat_1D_cylindrical(
    r_inner: float = 0.1,
    r_outer: float = 1.0,
    nr: int = 50,
    diffusivity: float = 1.0,
    T_inner: float = 100.0,
    T_outer: float = 20.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
) -> SolveResult:
    """1D radial cylindrical heat: u_t = k (1/r) ∂_r(r ∂_r u), r-weighted form.

    Reference tool: fenics_mcp_server.py:2220-2292; raw solver :769-923.
    """
    mesh = interval_mesh(nr, r_inner, r_outer)
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=weight_r, weight_quad_degree=3,
        bc_builder=_radial_bcs(r_inner, T_inner, T_outer),
        source_type=source_type, source_value=source_value,
        steady=steady, T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, curvilinear_ic=True,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cylindrical",
        "geometry_type": "cylinder" if r_inner < 1e-10 else "annulus",
        "r_inner": r_inner, "r_outer": r_outer,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "heat_1d_cylindrical")


def solve_heat_1D_spherical(
    r_inner: float = 0.1,
    r_outer: float = 1.0,
    nr: int = 50,
    diffusivity: float = 1.0,
    T_inner: float = 100.0,
    T_outer: float = 20.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
) -> SolveResult:
    """1D radial spherical heat: u_t = k (1/r²) ∂_r(r² ∂_r u), r²-weighted form.

    Reference tool: fenics_mcp_server.py:2295-2367; raw solver :926-1060.
    """
    mesh = interval_mesh(nr, r_inner, r_outer)
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=weight_r2, weight_quad_degree=4,
        bc_builder=_radial_bcs(r_inner, T_inner, T_outer),
        source_type=source_type, source_value=source_value,
        steady=steady, T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, curvilinear_ic=True,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "spherical",
        "geometry_type": "sphere" if r_inner < 1e-10 else "spherical_shell",
        "r_inner": r_inner, "r_outer": r_outer,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "heat_1d_spherical")


def solve_heat_2D_cylindrical(
    r_inner: float = 0.1,
    r_outer: float = 1.0,
    z_length: float = 2.0,
    nr: int = 30,
    nz: int = 30,
    diffusivity: float = 1.0,
    T_boundary: float = 20.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
) -> SolveResult:
    """Axisymmetric cylindrical heat in the (r, z) plane, r-weighted form.

    Reference tool: fenics_mcp_server.py:2370-2445; raw solver :1063-1188.
    """
    mesh = rectangle_mesh(nr, nz, (r_inner, 0.0), (r_outer, z_length))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=weight_r, weight_quad_degree=3,
        bc_builder=lambda m: [(m.boundary_mask(), T_boundary)],
        source_type=source_type, source_value=source_value,
        steady=steady, T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, curvilinear_ic=True,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "cylindrical",
        "geometry_type": "cylinder" if r_inner < 1e-10 else "annular_cylinder",
        "r_inner": r_inner, "r_outer": r_outer, "z_length": z_length,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_rz, times, values, 2, meta, stats)
    return _result(field, data_dir, "heat_2d_cylindrical")


def solve_heat_2D_spherical(
    r_inner: float = 0.1,
    r_outer: float = 1.0,
    nr: int = 30,
    ntheta: int = 30,
    diffusivity: float = 1.0,
    T_boundary: float = 20.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
) -> SolveResult:
    """Axisymmetric spherical heat in the (r, θ) plane, r² sinθ-weighted form.

    Reference tool: fenics_mcp_server.py:2448-2520; raw solver :1191-1323.
    """
    mesh = rectangle_mesh(nr, ntheta, (r_inner, 0.0), (r_outer, np.pi))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=weight_r2_sin_theta,
        weight_quad_degree=6,
        bc_builder=lambda m: [(m.boundary_mask(), T_boundary)],
        source_type=source_type, source_value=source_value,
        steady=steady, T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, curvilinear_ic=True,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "spherical",
        "geometry_type": "sphere" if r_inner < 1e-10 else "spherical_shell",
        "r_inner": r_inner, "r_outer": r_outer,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_rtheta, times, values, 2, meta, stats)
    return _result(field, data_dir, "heat_2d_spherical")


def solve_heat_3D_spherical(
    r_inner: float = 0.1,
    r_outer: float = 1.0,
    nr: int = 20,
    ntheta: int = 20,
    nphi: int = 20,
    diffusivity: float = 1.0,
    T_boundary: float = 20.0,
    T_initial: float = 20.0,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
    steady: bool = False,
    source_type: str = "none",
    source_value: float = 0.0,
    initial_type: str = "constant",
    initial_amplitude: float = 1.0,
) -> SolveResult:
    """Full 3D spherical heat on (r, θ, φ) parameter space, r² sinθ weight.

    Reference tool: fenics_mcp_server.py:2044-2119; raw solver :1326-1464.
    """
    mesh = box_mesh(nr, ntheta, nphi, (r_inner, 0.0, 0.0),
                    (r_outer, np.pi, 2.0 * np.pi))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=diffusivity, weight_fn=weight_r2_sin_theta,
        weight_quad_degree=6,
        bc_builder=lambda m: [(m.boundary_mask(), T_boundary)],
        source_type=source_type, source_value=source_value,
        steady=steady, T_initial=T_initial, initial_type=initial_type,
        initial_amplitude=initial_amplitude, curvilinear_ic=True,
        dt=dt, num_steps=num_steps,
    )
    times, values, stats = heat.solve_heat_problem(p)
    meta = {
        "name": "temperature", "unit": "°C", "pde": "heat",
        "coordinate_system": "spherical",
        "geometry_type": "sphere" if r_inner < 1e-10 else "spherical_shell",
        "r_inner": r_inner, "r_outer": r_outer,
        "source_type": source_type, "source_value": source_value, "steady": steady,
    }
    field = _pack(mesh, embed_spherical, times, values, 3, meta, stats)
    return _result(field, data_dir, "heat_3d_spherical")


# ======================================================================
# Elasticity
# ======================================================================

def solve_elasticity_1D_static(
    L: float = 1.0,
    nx: int = 50,
    E: float = 210e9,
    area: float = 1.0,
    body_force: float = 0.0,
    quantity: str = "stress",
    data_dir: str = "data",
) -> SolveResult:
    """1D axial bar −(EA u′)′ = f, fixed-free; axial stress/strain output
    (quantity="displacement" additionally returns u itself — extension).

    Reference tool: fenics_mcp_server.py:2523-2588; raw solver :1470-1587.
    """
    x, values, stats = elast.solve_bar_1d(L, nx, E, area, body_force, quantity)
    field_name, unit = _bar_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_1d",
        "L": L, "E": E, "area": area, "body_force": body_force,
        "quantity": quantity, "solver_stats": stats,
    }
    return _bar_result(x, values, meta, data_dir, f"elasticity_1d_{quantity}")


def solve_elasticity_2D_static(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 30,
    ny: int = 30,
    E: float = 210e9,
    nu: float = 0.3,
    body_fx: float = 0.0,
    body_fy: float = 0.0,
    quantity: str = "stress",
    plane_stress: bool = True,
    data_dir: str = "data",
) -> SolveResult:
    """2D static elasticity (plane stress/strain), clamped left edge,
    von Mises output (quantity="displacement" returns |u| — extension).
    Reference tool: fenics_mcp_server.py:2590-2678."""
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    mode = "plane_stress" if plane_stress else "plane_strain"
    values, stats = elast.solve_elasticity_nd(
        mesh, E, nu, np.array([body_fx, body_fy]), mode, quantity)
    field_name, unit = _von_mises_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_2d",
        "Lx": Lx, "Ly": Ly, "E": E, "nu": nu,
        "body_fx": body_fx, "body_fy": body_fy,
        "quantity": quantity, "plane_stress": plane_stress,
    }
    field = _pack(mesh, embed_plane, np.array([0.0]), values[None, :], 2,
                  meta, stats)
    return _result(field, data_dir, f"elasticity_2d_{quantity}")


def solve_elasticity_3D_static(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    E: float = 210e9,
    nu: float = 0.3,
    body_fx: float = 0.0,
    body_fy: float = 0.0,
    body_fz: float = 0.0,
    quantity: str = "stress",
    data_dir: str = "data",
) -> SolveResult:
    """3D static elasticity on a box, clamped x=0 face, von Mises output
    (quantity="displacement" returns |u| — extension).

    Reference tool: fenics_mcp_server.py:2680-2761; raw solver :1749-1892.
    """
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    values, stats = elast.solve_elasticity_nd(
        mesh, E, nu, np.array([body_fx, body_fy, body_fz]), "3d", quantity)
    field_name, unit = _von_mises_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_3d",
        "Lx": Lx, "Ly": Ly, "Lz": Lz, "E": E, "nu": nu,
        "body_fx": body_fx, "body_fy": body_fy, "body_fz": body_fz,
        "quantity": quantity,
    }
    field = _pack(mesh, embed_identity3, np.array([0.0]), values[None, :], 3,
                  meta, stats)
    return _result(field, data_dir, f"elasticity_3d_{quantity}")


# ----------------------------------------------------------------------
# Elasticity with surface loads (extension tools)
# ----------------------------------------------------------------------
# Beyond the reference surface: its elasticity tools accept body forces
# only (fenics_mcp_server.py:1670-1674, :1820-1824); end loads, surface
# tractions and pressures are the textbook cantilever/plate queries.

def _resolve_face_loads(loads: Optional[dict], mesh) -> list:
    """Per-face load specs → (axis, side, traction_vector) list.

    Spec per face (faces named as in ``models.heat._FACE_NAMES``):
    {"type": "traction", "vector": [..]}  N/m² applied as-is;
    {"type": "force",    "vector": [..]}  total N, divided by face area;
    {"type": "pressure", "value": p}      t = −p·n̂ (positive = pushing in).
    """
    d = mesh.dim
    out = []
    for face, spec in (loads or {}).items():
        for axis, side in heat._face_keys(d, face):
            area = 1.0
            for a in range(d):
                if a != axis:
                    area *= mesh.extent[a]
            kind = str(spec.get("type", "traction")).strip().lower()
            if kind == "traction":
                t = np.asarray(spec.get("vector", [0.0] * d), np.float64)
            elif kind == "force":
                t = np.asarray(spec.get("vector", [0.0] * d),
                               np.float64) / area
            elif kind == "pressure":
                n = np.zeros(d)
                n[axis] = 1.0 if side else -1.0
                t = -float(spec.get("value", 0.0)) * n
            else:
                raise ValueError(f"unknown load type {kind!r} for {face!r}")
            out.append((axis, side, t))
    return out


def solve_elasticity_1D_loaded(
    L: float = 1.0,
    nx: int = 50,
    E: float = 210e9,
    area: float = 1.0,
    end_load: float = 0.0,
    body_force: float = 0.0,
    quantity: str = "stress",
    data_dir: str = "data",
) -> SolveResult:
    """1D axial bar with an end point-load P at the free end (extension
    tool): EA u′(L) = P, so σ = P/A and u = P x/(EA) exactly."""
    x, values, stats = elast.solve_bar_1d(L, nx, E, area, body_force,
                                          quantity, end_load=end_load)
    field_name, unit = _bar_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_1d",
        "L": L, "E": E, "area": area, "body_force": body_force,
        "end_load": end_load, "quantity": quantity, "solver_stats": stats,
    }
    return _bar_result(x, values, meta, data_dir,
                       f"elasticity_1d_loaded_{quantity}")


def solve_elasticity_2D_loaded(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 30,
    ny: int = 30,
    E: float = 210e9,
    nu: float = 0.3,
    loads: Optional[dict] = None,
    body_fx: float = 0.0,
    body_fy: float = 0.0,
    quantity: str = "stress",
    plane_stress: bool = True,
    data_dir: str = "data",
) -> SolveResult:
    """2D static elasticity with per-face surface loads (extension tool);
    clamped left edge, von Mises output.  See :func:`_resolve_face_loads`
    for the loads spec."""
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    mode = "plane_stress" if plane_stress else "plane_strain"
    values, stats = elast.solve_elasticity_nd(
        mesh, E, nu, np.array([body_fx, body_fy]), mode, quantity,
        traction_faces=_resolve_face_loads(loads, mesh))
    field_name, unit = _von_mises_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_2d",
        "Lx": Lx, "Ly": Ly, "E": E, "nu": nu,
        "body_fx": body_fx, "body_fy": body_fy,
        "loads": _mixed_bc_meta(loads),
        "quantity": quantity, "plane_stress": plane_stress,
    }
    field = _pack(mesh, embed_plane, np.array([0.0]), values[None, :], 2,
                  meta, stats)
    return _result(field, data_dir, f"elasticity_2d_loaded_{quantity}")


def solve_elasticity_3D_loaded(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    E: float = 210e9,
    nu: float = 0.3,
    loads: Optional[dict] = None,
    body_fx: float = 0.0,
    body_fy: float = 0.0,
    body_fz: float = 0.0,
    quantity: str = "stress",
    data_dir: str = "data",
) -> SolveResult:
    """3D static elasticity with per-face surface loads (extension tool);
    clamped x=0 face, von Mises output."""
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    values, stats = elast.solve_elasticity_nd(
        mesh, E, nu, np.array([body_fx, body_fy, body_fz]), "3d", quantity,
        traction_faces=_resolve_face_loads(loads, mesh))
    field_name, unit = _von_mises_name_unit(quantity)
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_3d",
        "Lx": Lx, "Ly": Ly, "Lz": Lz, "E": E, "nu": nu,
        "body_fx": body_fx, "body_fy": body_fy, "body_fz": body_fz,
        "loads": _mixed_bc_meta(loads), "quantity": quantity,
    }
    field = _pack(mesh, embed_identity3, np.array([0.0]), values[None, :], 3,
                  meta, stats)
    return _result(field, data_dir, f"elasticity_3d_loaded_{quantity}")


# ======================================================================
# Modal analysis and elastodynamics (extension tools)
# ======================================================================

def solve_elasticity_2D_modal(
    Lx: float = 1.0,
    Ly: float = 0.2,
    nx: int = 24,
    ny: int = 6,
    E: float = 210e9,
    nu: float = 0.3,
    rho: float = 7800.0,
    num_modes: int = 4,
    plane_stress: bool = True,
    data_dir: str = "data",
) -> SolveResult:
    """2D in-plane natural frequencies + mode shapes, clamped left edge
    (extension tool; see :func:`solve_elasticity_3D_modal`)."""

    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    mode = "plane_stress" if plane_stress else "plane_strain"
    lam_p, mu = elast.lame_parameters(E, nu, mode)
    K = assembly.assemble_elasticity_stencil(mesh, lam_p, mu)
    M = elast.assemble_vector_mass(mesh, rho)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)

    def coarse_level(mesh_c):
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam_p, mu)
        bc_c = DirichletBC.from_masks([(mesh_c.face_mask(0, 0), 0.0)],
                                      mesh_c.node_shape, vdim=2)
        return K_c, bc_c

    with request() as phases:
        lams, modes, stats = smallest_modes(K, M, mesh, bc,
                                            num_modes=num_modes, vdim=2,
                                            mg_level_builder=coarse_level)
    stats = {**stats, **phases}
    freqs = np.sqrt(np.maximum(lams, 0.0)) / (2.0 * np.pi)
    frames = []
    for j in range(len(lams)):
        mag = np.linalg.norm(modes[j], axis=-1)
        frames.append(flatten_values(mag / max(mag.max(), 1e-300),
                                     mesh.dim))
    values = np.stack(frames)
    meta = {
        "name": "mode_shape", "unit": "-", "pde": "elasticity_modal",
        "coordinate_system": "cartesian",
        "Lx": Lx, "Ly": Ly, "E": E, "nu": nu, "rho": rho,
        "plane_stress": plane_stress,
        "frequencies_hz": [float(f) for f in freqs],
        "num_modes": int(num_modes),
    }
    field = _pack(mesh, embed_plane, freqs, values, 2, meta, stats)
    return _result(field, data_dir, "elasticity_2d_modal")


def solve_elasticity_3D_modal(
    Lx: float = 1.0,
    Ly: float = 0.2,
    Lz: float = 0.2,
    nx: int = 16,
    ny: int = 6,
    nz: int = 6,
    E: float = 210e9,
    nu: float = 0.3,
    rho: float = 7800.0,
    num_modes: int = 4,
    data_dir: str = "data",
) -> SolveResult:
    """Natural frequencies + mode shapes of a clamped-free box (extension
    tool — the reference has no eigen capability).

    Solves K φ = ω² M φ with Rayleigh–Ritz subspace iteration
    (ops/eigen.py).  The artifact packs one frame per mode — the
    displacement magnitude |φ| — with the frame "times" carrying the
    frequencies in Hz, so the standard animated plotters page through the
    mode shapes.  ``meta.frequencies_hz`` holds the list.
    """

    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    lam_p, mu = elast.lame_parameters(E, nu, "3d")
    K = assembly.assemble_elasticity_stencil(mesh, lam_p, mu)
    M = elast.assemble_vector_mass(mesh, rho)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)

    def coarse_level(mesh_c):
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam_p, mu)
        bc_c = DirichletBC.from_masks([(mesh_c.face_mask(0, 0), 0.0)],
                                      mesh_c.node_shape, vdim=3)
        return K_c, bc_c

    with request() as phases:
        lams, modes, stats = smallest_modes(K, M, mesh, bc,
                                            num_modes=num_modes, vdim=3,
                                            mg_level_builder=coarse_level)
    stats = {**stats, **phases}
    freqs = np.sqrt(np.maximum(lams, 0.0)) / (2.0 * np.pi)
    # per-mode displacement magnitude, normalized to unit max for display
    frames = []
    for j in range(len(lams)):
        mag = np.linalg.norm(modes[j], axis=-1)
        frames.append(flatten_values(mag / max(mag.max(), 1e-300),
                                     mesh.dim))
    values = np.stack(frames)
    meta = {
        "name": "mode_shape", "unit": "-", "pde": "elasticity_modal",
        "coordinate_system": "cartesian",
        "Lx": Lx, "Ly": Ly, "Lz": Lz, "E": E, "nu": nu, "rho": rho,
        "frequencies_hz": [float(f) for f in freqs],
        "num_modes": int(num_modes),
    }
    field = _pack(mesh, embed_identity3, freqs, values, 3, meta, stats)
    return _result(field, data_dir, "elasticity_3d_modal")


def solve_elasticity_3D_dynamic(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 10,
    ny: int = 10,
    nz: int = 10,
    E: float = 210e9,
    nu: float = 0.3,
    rho: float = 7800.0,
    body_fx: float = 0.0,
    body_fy: float = 0.0,
    body_fz: float = 0.0,
    dt: float = 1e-4,
    num_steps: int = 50,
    data_dir: str = "data",
) -> SolveResult:
    """3D elastodynamics ρü − ∇·σ(u) = f on a box, clamped x=0 face.

    **Extension beyond the reference** (14th tool): the reference's
    elasticity solvers are all static (fenics_mcp_server.py:1470-1892).
    Implicit Newmark-β (energy-conserving average acceleration,
    ``ops.timestepping.run_newmark``); outputs the displacement-magnitude
    time series (animatable with the standard 3D volume plotter)."""
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    res, info = elast.solve_elasticity_dynamic(
        mesh, E, nu, rho, np.array([body_fx, body_fy, body_fz]), "3d",
        dt, num_steps)
    # [Nt+1, *shape, 3] → displacement magnitude [Nt+1, N]
    mag = np.linalg.norm(res.values, axis=-1).reshape(res.values.shape[0], -1)
    meta = {
        "name": "displacement_magnitude", "unit": "m",
        "pde": "elasticity_3d_dynamic",
        "Lx": Lx, "Ly": Ly, "Lz": Lz, "E": E, "nu": nu, "rho": rho,
        "body_fx": body_fx, "body_fy": body_fy, "body_fz": body_fz,
        "dt": dt, "num_steps": num_steps,
        "integrator": "newmark_beta", "beta": 0.25, "gamma": 0.5,
    }
    field = _pack(mesh, embed_identity3, res.times, mag, 3, meta, info)
    return _result(field, data_dir, "elasticity_3d_dynamic")


# ======================================================================
# Wave equation (extension — the reference parses pde_type="wave" but has
# no solver for it; see models/wave.py)
# ======================================================================

def solve_wave_1D(
    length: float = 2.0,
    nx: int = 50,
    wave_speed: float = 1.0,
    boundary_value: float = 0.0,
    source_value: float = 0.0,
    initial_type: str = "sine",
    initial_amplitude: float = 1.0,
    initial_wavenumber: Optional[float] = None,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
) -> SolveResult:
    """1D wave equation u_tt = c² u_xx + f on (0, length), Dirichlet ends.

    **Extension beyond the reference**: its parser emits pde_type="wave"
    (pde_parser_agent.py:205) but no solver exists.  Implicit Newmark-β
    (β=¼, γ=½: unconditionally stable, energy-conserving).
    ``initial_wavenumber=None`` → the fundamental standing mode π/length
    (sine IC vanishes at both ends)."""
    mesh = interval_mesh(nx, 0.0, length)
    p = wave.WaveProblem(
        mesh=mesh, wave_speed=wave_speed, boundary_value=boundary_value,
        source_value=source_value, initial_type=initial_type,
        initial_amplitude=initial_amplitude,
        initial_wavenumber=initial_wavenumber, dt=dt, num_steps=num_steps)
    times, values, stats = wave.solve_wave_problem(p)
    meta = {
        "name": "displacement", "unit": "m", "pde": "wave_1d",
        "coordinate_system": "cartesian", "length": length,
        "wave_speed": wave_speed, "boundary_value": boundary_value,
        "source_value": source_value, "dt": dt, "num_steps": num_steps,
        "integrator": "newmark_beta", "beta": 0.25, "gamma": 0.5,
    }
    field = _pack(mesh, embed_line, times, values, 1, meta, stats)
    return _result(field, data_dir, "wave_1d")


def solve_wave_2D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    nx: int = 30,
    ny: int = 30,
    wave_speed: float = 1.0,
    boundary_value: float = 0.0,
    source_value: float = 0.0,
    initial_type: str = "sine",
    initial_amplitude: float = 1.0,
    initial_wavenumber: Optional[float] = None,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
) -> SolveResult:
    """2D wave (vibrating membrane) on [0,Lx]×[0,Ly], fixed edges.

    Extension beyond the reference (see solve_wave_1D)."""
    mesh = rectangle_mesh(nx, ny, (0.0, 0.0), (Lx, Ly))
    p = wave.WaveProblem(
        mesh=mesh, wave_speed=wave_speed, boundary_value=boundary_value,
        source_value=source_value, initial_type=initial_type,
        initial_amplitude=initial_amplitude,
        initial_wavenumber=initial_wavenumber, dt=dt, num_steps=num_steps)
    times, values, stats = wave.solve_wave_problem(p)
    meta = {
        "name": "displacement", "unit": "m", "pde": "wave_2d",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly,
        "wave_speed": wave_speed, "boundary_value": boundary_value,
        "source_value": source_value, "dt": dt, "num_steps": num_steps,
        "integrator": "newmark_beta", "beta": 0.25, "gamma": 0.5,
    }
    field = _pack(mesh, embed_plane, times, values, 2, meta, stats)
    return _result(field, data_dir, "wave_2d")


def solve_wave_3D(
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    nx: int = 20,
    ny: int = 20,
    nz: int = 20,
    wave_speed: float = 1.0,
    boundary_value: float = 0.0,
    source_value: float = 0.0,
    initial_type: str = "sine",
    initial_amplitude: float = 1.0,
    initial_wavenumber: Optional[float] = None,
    dt: float = 0.01,
    num_steps: int = 50,
    data_dir: str = "data",
) -> SolveResult:
    """3D acoustic wave on a box, fixed boundary.

    Extension beyond the reference (see solve_wave_1D)."""
    mesh = box_mesh(nx, ny, nz, (0.0, 0.0, 0.0), (Lx, Ly, Lz))
    p = wave.WaveProblem(
        mesh=mesh, wave_speed=wave_speed, boundary_value=boundary_value,
        source_value=source_value, initial_type=initial_type,
        initial_amplitude=initial_amplitude,
        initial_wavenumber=initial_wavenumber, dt=dt, num_steps=num_steps)
    times, values, stats = wave.solve_wave_problem(p)
    meta = {
        "name": "displacement", "unit": "m", "pde": "wave_3d",
        "coordinate_system": "cartesian", "Lx": Lx, "Ly": Ly, "Lz": Lz,
        "wave_speed": wave_speed, "boundary_value": boundary_value,
        "source_value": source_value, "dt": dt, "num_steps": num_steps,
        "integrator": "newmark_beta", "beta": 0.25, "gamma": 0.5,
    }
    field = _pack(mesh, embed_identity3, times, values, 3, meta, stats)
    return _result(field, data_dir, "wave_3d")


# ======================================================================
# Plotting (implemented in pde_solver_tpu_torch.viz, re-exported here)
# ======================================================================

def plot_time_series_field_from_file(
    data_file: str,
    field_name: Optional[str] = None,
    unit: Optional[str] = None,
    output_dir: str = "plots",
    filename: Optional[str] = None,
) -> PlotResult:
    """Load a pickled TimeSeriesField and render an animated HTML plot.

    Reference tool: fenics_mcp_server.py:2764-2937.
    """
    from pde_solver_tpu_torch.viz.plots import plot_time_series_field_from_file as impl
    return impl(data_file=data_file, field_name=field_name, unit=unit,
                output_dir=output_dir, filename=filename)


def plot_time_series_field(
    coords,
    values,
    times,
    dim: int = 1,
    field_name: str = "u",
    unit: str = "",
    output_dir: str = "plots",
    filename: str = "field_timeseries_3d.html",
    domain_bounds=None,
    geometry_type: Optional[str] = None,
    geometry_params=None,
) -> PlotResult:
    """Render raw arrays into an animated HTML plot.

    Reference tool: fenics_mcp_server.py:3409-4140.
    """
    from pde_solver_tpu_torch.viz.plots import plot_time_series_field as impl
    return impl(coords=coords, values=values, times=times, dim=dim,
                field_name=field_name, unit=unit, output_dir=output_dir,
                filename=filename, domain_bounds=domain_bounds,
                geometry_type=geometry_type, geometry_params=geometry_params)
