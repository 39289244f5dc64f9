"""Heat-equation solver family: what the Cartesian and curvilinear heat
tools solve with.

Counterpart of ``pde_solver_tpu.models.heat``: ``HeatProblem``, the
initial field, the generic entry point ``solve_heat_problem`` (steady
through the linear-solve facade, transient through
``ops.timestepping.run_transient``) with Robin and flux faces
(``ops.surface``) folded into every multigrid level and sinusoidal driving
handed to the scan, the nonlinear Picard solve ``solve_heat_nonlinear``, the
per-face BC parser of the ``_mixed`` tools, the coordinate weights and
embeddings, the composite-core diffusivity marking, and the face names the
``_loaded`` elasticity tools resolve too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from pde_solver_tpu_torch.config import SolverConfig, get_config
from pde_solver_tpu_torch.mesh import StructuredMesh, flatten_values
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import solve_stencil_system
from pde_solver_tpu_torch.ops.projection import project_function
from pde_solver_tpu_torch.ops.timestepping import run_transient
from pde_solver_tpu_torch.utils.observability import get_logger, phase_timer

WeightFn = Callable[[np.ndarray], np.ndarray]


@dataclass
class HeatProblem:
    mesh: StructuredMesh
    diffusivity: float = 1.0
    weight_fn: Optional[WeightFn] = None          # coordinate weight w(x)
    weight_quad_degree: int = 4                   # quadrature degree for w-forms
    kappa_cells: Optional[np.ndarray] = None      # per-sub-element κ (composite)
    # mesh-parametric κ constructor (e.g. composite core re-marked per level):
    # enables geometric multigrid for composite-coefficient solves — the
    # coarse operators re-assemble with the coarse-mesh marking, which keeps
    # every level SPD; the flexible MG-PCG wrapper absorbs the (slight)
    # non-Galerkin coarse/fine coefficient mismatch.
    kappa_builder: Optional[Callable[[StructuredMesh], np.ndarray]] = None
    bc_pairs: Sequence[Tuple[np.ndarray, float]] = ()
    # mesh-parametric BC constructor: enables geometric-multigrid level
    # rebuilds for steady solves (pairs == bc_builder(mesh) when provided)
    bc_builder: Optional[Callable[[StructuredMesh], Sequence]] = None
    # Robin (convective) faces: (axis, side, h, T_inf) per face, adding
    # ∫_Γ h u v ds to the stiffness and ∫_Γ h T_inf v ds to the load
    # (-κ ∂u/∂n = h (u - T_inf) on Γ).  Beyond-reference capability: the
    # reference heat solvers are Dirichlet-only (fenics_mcp_server.py:294-297).
    robin_faces: Sequence[Tuple[int, int, float, float]] = ()
    # Prescribed-flux (Neumann) faces: (axis, side, q_in) with q_in the
    # INWARD heat flux (κ ∂u/∂n = q_in on Γ → ∫_Γ q_in v ds on the load)
    flux_faces: Sequence[Tuple[int, int, float]] = ()
    source_type: str = "none"
    source_value: float = 0.0
    steady: bool = False
    # initial condition (transient)
    T_initial: float = 0.0
    initial_type: str = "constant"                # constant | zero | cosine | sine
    initial_amplitude: float = 1.0
    initial_wavenumber: float = 1.0
    curvilinear_ic: bool = False                  # reference treats all IC types as constant
    # stepping
    dt: float = 0.01
    num_steps: int = 50
    theta: Optional[float] = None                 # 1 = backward Euler, 0.5 =
                                                  # Crank-Nicolson; None → the
                                                  # SolverConfig.theta policy
    # sinusoidal driving (extension: the reference's sources/BCs are
    # constant): Dirichlet data g(t) = g0 + sin(ω t + φ)·amp on the faces
    # in bc_amp_pairs, and/or source f(t) = f0 + sin(ω t + φ)·source_amp —
    # both share one (mod_omega, mod_phase) sinusoid
    bc_amp_pairs: Sequence[Tuple[np.ndarray, float]] = ()
    source_amp: float = 0.0
    mod_omega: float = 0.0
    mod_phase: float = 0.0


def _apply_surface_terms(p: HeatProblem, mesh: StructuredMesh,
                         K: Dict) -> Tuple[Dict, np.ndarray]:
    """Fold Robin/flux boundary integrals into (stiffness, load).

    Robin: K += h·(surface mass on Γ), b += h·T_inf·(surface load on Γ);
    Neumann: b += q_in·(surface load on Γ).  Both respect the problem's
    coordinate weight (curvilinear solids), restricted to the face plane.
    The Robin term is PSD, so the constrained operator stays SPD for CG/MG.
    """
    from pde_solver_tpu_torch.ops import surface

    b = np.zeros(mesh.node_shape, dtype=np.float64)
    for axis, side, h, t_inf in p.robin_faces:
        if h == 0.0:
            continue
        K = surface.add_stencil(
            K, surface.assemble_face_mass(mesh, int(axis), int(side),
                                          coeff=float(h),
                                          weight_fn=p.weight_fn))
        if t_inf != 0.0:
            b += surface.assemble_face_load(
                mesh, int(axis), int(side), coeff=float(h) * float(t_inf),
                weight_fn=p.weight_fn,
                quad_degree=p.weight_quad_degree)
    for axis, side, q_in in p.flux_faces:
        if q_in != 0.0:
            b += surface.assemble_face_load(
                mesh, int(axis), int(side), coeff=float(q_in),
                weight_fn=p.weight_fn,
                quad_degree=p.weight_quad_degree)
    return K, b


def _initial_field(p: HeatProblem) -> np.ndarray:
    mesh = p.mesh
    if p.curvilinear_ic or p.initial_type in (None, "constant"):
        # Reference curvilinear solvers assign the constant for every IC type
        # (fenics_mcp_server.py:873-876 and analogs).
        return np.full(mesh.node_shape, float(p.T_initial), dtype=np.float64)
    if p.initial_type == "zero":
        return np.zeros(mesh.node_shape, dtype=np.float64)
    if p.initial_type in ("cosine", "sine"):
        A, k = float(p.initial_amplitude), float(p.initial_wavenumber)
        trig = np.cos if p.initial_type == "cosine" else np.sin

        def fn(x):  # A * Π_i trig(k x_i) — the reference's separable IC
            out = np.full(x.shape[:-1], A, dtype=np.float64)
            for a in range(mesh.dim):
                out = out * trig(k * x[..., a])
            return out

        # FEniCS projects (consistent mass), fenics_mcp_server.py:284,:415,:679
        return project_function(mesh, fn, quad_degree=4)
    return np.full(mesh.node_shape, float(p.T_initial), dtype=np.float64)


def solve_heat_problem(p: HeatProblem, config: Optional[SolverConfig] = None
                       ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Returns (times [Nt], values [Nt, N] flat float64, stats dict)."""
    cfg = config or get_config()
    mesh = p.mesh
    phases: Dict[str, float] = {}

    with phase_timer(phases, "assembly"):
        # Stiffness ∫ κ w ∇u·∇v; mass ∫ w u v; load ∫ w f v
        stiff_deg = p.weight_quad_degree if p.weight_fn is not None else 2
        kappa = p.kappa_cells
        if kappa is None and p.kappa_builder is not None:
            kappa = p.kappa_builder(mesh)
        K = assembly.assemble_scalar_stencil(
            mesh, "stiffness", weight_fn=p.weight_fn,
            cell_coeff=kappa, quad_degree=stiff_deg,
        )
        if kappa is None and p.diffusivity != 1.0:
            K = {o: p.diffusivity * W for o, W in K.items()}

        if p.source_type == "constant" and p.source_value != 0.0:
            b = p.source_value * assembly.assemble_load(
                mesh, weight_fn=p.weight_fn, quad_degree=p.weight_quad_degree)
        else:
            b = np.zeros(mesh.node_shape, dtype=np.float64)

        if p.robin_faces or p.flux_faces:
            K, b_surf = _apply_surface_terms(p, mesh, K)
            b = b + b_surf

        pairs = list(p.bc_pairs) if p.bc_pairs else (
            list(p.bc_builder(mesh)) if p.bc_builder else [])
        bc = DirichletBC.from_masks(pairs, mesh.node_shape)

    mg_builder = None
    if p.bc_builder is not None and (kappa is None
                                     or p.kappa_builder is not None):
        def mg_builder(mesh_c):
            kappa_c = (p.kappa_builder(mesh_c)
                       if p.kappa_builder is not None else None)
            K_c = assembly.assemble_scalar_stencil(
                mesh_c, "stiffness", weight_fn=p.weight_fn,
                cell_coeff=kappa_c, quad_degree=stiff_deg)
            if kappa_c is None and p.diffusivity != 1.0:
                K_c = {o: p.diffusivity * W for o, W in K_c.items()}
            if p.robin_faces or p.flux_faces:
                # coarse levels carry the same Robin surface mass (the load
                # part is irrelevant for the MG operator)
                K_c, _ = _apply_surface_terms(p, mesh_c, K_c)
            bc_c = DirichletBC.from_masks(list(p.bc_builder(mesh_c)),
                                          mesh_c.node_shape)
            return K_c, bc_c

    if p.steady:
        with phase_timer(phases, "solve"):
            x, stats = solve_stencil_system(K, mesh, bc, b, config=cfg,
                                            mg_level_builder=mg_builder)
        values = flatten_values(x, mesh.dim)[None, :]
        times = np.array([0.0])
        info = {
            "steady": True,
            "cg_iterations": int(stats.iterations),
            "relative_residual": float(stats.relative_residual),
            "converged": bool(stats.converged),
            "convergence_target": stats.target,
        }
    else:
        with phase_timer(phases, "assembly"):
            M = assembly.assemble_scalar_stencil(
                mesh, "mass", weight_fn=p.weight_fn,
                quad_degree=max(p.weight_quad_degree, 2) if p.weight_fn is not None else 2,
            )
            u0 = np.asarray(bc.apply_values(_initial_field(p)), dtype=np.float64)
        mg_builder_t = None
        if mg_builder is not None:
            def mg_builder_t(mesh_c):
                K_c, bc_c = mg_builder(mesh_c)
                M_c = assembly.assemble_scalar_stencil(
                    mesh_c, "mass", weight_fn=p.weight_fn,
                    quad_degree=(max(p.weight_quad_degree, 2)
                                 if p.weight_fn is not None else 2))
                return K_c, M_c, bc_c
        time_mod = None
        if p.mod_omega and (len(p.bc_amp_pairs) or p.source_amp):
            time_mod = {"omega": float(p.mod_omega),
                        "phase": float(p.mod_phase)}
            if p.source_amp:
                time_mod["source_amp"] = p.source_amp * \
                    assembly.assemble_load(mesh, weight_fn=p.weight_fn,
                                           quad_degree=p.weight_quad_degree)
            if len(p.bc_amp_pairs):
                amp_bc = DirichletBC.from_masks(list(p.bc_amp_pairs),
                                                mesh.node_shape)
                time_mod["bc_amp_values"] = np.asarray(
                    amp_bc.values * (1.0 - amp_bc.free_mask), np.float64)
        with phase_timer(phases, "solve"):
            res = run_transient(K, M, mesh, bc, b, u0, dt=p.dt,
                                num_steps=p.num_steps,
                                theta=p.theta if p.theta is not None else cfg.theta,
                                config=cfg, mg_level_builder=mg_builder_t,
                                time_mod=time_mod)
        values = np.stack([flatten_values(v, mesh.dim) for v in res.values])
        times = res.times
        # explicit per-step target: the worst step residual must meet the
        # larger of the per-step inner tolerance and the accuracy contract
        step_target = max(cfg.transient_inner_tol, cfg.accuracy_target)
        info = {
            "steady": False,
            "cg_iterations": int(res.total_cg_iterations),
            "relative_residual": float(res.max_relative_residual),
            "converged": bool(res.max_relative_residual <= step_target),
            "convergence_target": step_target,
            # stepping throughput = num_steps/scan_seconds; setup_seconds is
            # the one-time host prep (system + MG hierarchy build/upload);
            # fetch_seconds is the trajectory device→host retrieval
            "scan_seconds": float(res.scan_seconds),
            "setup_seconds": float(res.setup_seconds),
            "fetch_seconds": float(res.fetch_seconds),
        }
    info.update({"num_dofs": mesh.num_nodes, **phases})
    get_logger().info(
        "heat solve: %d DOF steady=%s assembly=%.3fs solve=%.3fs iters=%d",
        mesh.num_nodes, p.steady, phases.get("assembly_seconds", 0.0),
        phases.get("solve_seconds", 0.0), info["cg_iterations"])
    return times, values, info


# ----------------------------------------------------------------------
# Nonlinear conductivity (extension: the reference is linear-only)
# ----------------------------------------------------------------------

def _cell_average(T_nodes: np.ndarray, dim: int) -> np.ndarray:
    """Average the 2^d corner nodes of every cell (shape [*cell_shape])."""
    out = None
    for corner in np.ndindex(*([2] * dim)):
        sl = tuple(slice(c, (None if c else -1)) for c in corner)
        out = T_nodes[sl] if out is None else out + T_nodes[sl]
    return out / (2 ** dim)


def solve_heat_nonlinear(p: HeatProblem, kappa0: float, beta: float,
                         config: Optional[SolverConfig] = None,
                         picard_tol: float = 1e-8, max_picard: int = 40,
                         ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Steady heat with κ(T) = κ0 (1 + β T) by Picard iteration.

    Each iteration evaluates κ at the per-cell average of the current
    iterate and re-solves the linearized SPD system through the standard
    stack; convergence is the relative iterate change.  Validated against
    the Kirchhoff-transform closed form (tests/test_torch_mixed_advection.py):
    θ = κ0 (T + βT²/2) is harmonic, so 1D profiles are the inverted
    quadratic of a straight line.  β must keep κ positive over the
    temperature range (checked per iteration).
    """
    cfg = config or get_config()
    mesh = p.mesh
    if not p.steady:
        raise ValueError("solve_heat_nonlinear handles steady problems; "
                         "transient κ(T) is not supported yet")
    pairs = list(p.bc_pairs) if p.bc_pairs else (
        list(p.bc_builder(mesh)) if p.bc_builder else [])
    bc = DirichletBC.from_masks(pairs, mesh.node_shape)
    if p.source_type == "constant" and p.source_value != 0.0:
        b = p.source_value * assembly.assemble_load(
            mesh, weight_fn=p.weight_fn, quad_degree=p.weight_quad_degree)
    else:
        b = np.zeros(mesh.node_shape, dtype=np.float64)

    # initial iterate: the linearization point is the BC-consistent field
    T = np.asarray(bc.apply_values(
        np.full(mesh.node_shape, float(p.T_initial))), np.float64)
    total_cg = 0
    rel = np.inf
    it = 0
    for it in range(1, max_picard + 1):
        kcells = kappa0 * (1.0 + beta * _cell_average(T, mesh.dim))
        if kcells.min() <= 0.0:
            raise ValueError(
                f"kappa(T) became non-positive (min {kcells.min():.3g}) — "
                "beta is too large for this temperature range")
        K = assembly.assemble_scalar_stencil(
            mesh, "stiffness", weight_fn=p.weight_fn, cell_coeff=kcells,
            quad_degree=(p.weight_quad_degree
                         if p.weight_fn is not None else 2))
        T_new, stats = solve_stencil_system(K, mesh, bc, b, config=cfg)
        T_new = np.asarray(T_new, np.float64)
        total_cg += int(stats.iterations)
        rel = (np.linalg.norm((T_new - T).ravel())
               / max(np.linalg.norm(T_new.ravel()), 1e-300))
        T = T_new
        if rel < picard_tol:
            break
    get_logger().info(
        "nonlinear heat: %d Picard iterations (%d CG total), change %.2e",
        it, total_cg, rel)
    values = flatten_values(T, mesh.dim)[None, :]
    info = {
        "steady": True, "nonlinear": True,
        "picard_iterations": it, "cg_iterations": total_cg,
        "relative_residual": float(rel),
        "converged": bool(rel < picard_tol),
        "convergence_target": picard_tol,
        "num_dofs": mesh.num_nodes,
    }
    return np.array([0.0]), values, info


# ----------------------------------------------------------------------
# Coordinate weights (param-space weak-form factors) and 3D embeddings
# ----------------------------------------------------------------------

def weight_r(x: np.ndarray) -> np.ndarray:
    """Cylindrical radial weight w = r (first coordinate)."""
    return x[..., 0]

def weight_r2(x: np.ndarray) -> np.ndarray:
    """Spherical radial weight w = r²."""
    return x[..., 0] ** 2

def weight_r2_sin_theta(x: np.ndarray) -> np.ndarray:
    """Axisymmetric/full spherical weight w = r² sin θ (θ = second coord)."""
    return x[..., 0] ** 2 * np.sin(x[..., 1])

def weight_r_yz(x: np.ndarray) -> np.ndarray:
    """Cylinder-in-box weight w = sqrt(y² + z²) (fenics_mcp_server.py:645)."""
    return np.sqrt(x[..., 1] ** 2 + x[..., 2] ** 2)


def embed_line(coords: np.ndarray) -> np.ndarray:
    out = np.zeros((len(coords), 3))
    out[:, 0] = coords[:, 0]
    return out

def embed_plane(coords: np.ndarray) -> np.ndarray:
    out = np.zeros((len(coords), 3))
    out[:, :2] = coords
    return out

def embed_rz(coords: np.ndarray) -> np.ndarray:
    """(r, z) → (r, 0, z) (fenics_mcp_server.py:1167)."""
    out = np.zeros((len(coords), 3))
    out[:, 0] = coords[:, 0]
    out[:, 2] = coords[:, 1]
    return out

def embed_rtheta(coords: np.ndarray) -> np.ndarray:
    """(r, θ) → (r sinθ, 0, r cosθ) (fenics_mcp_server.py:1296-1303)."""
    r, th = coords[:, 0], coords[:, 1]
    return np.stack([r * np.sin(th), np.zeros_like(r), r * np.cos(th)], axis=1)

def embed_identity3(coords: np.ndarray) -> np.ndarray:
    return coords.copy()

def embed_spherical(coords: np.ndarray) -> np.ndarray:
    """(r, θ, φ) → Cartesian (fenics_mcp_server.py:1439-1444)."""
    r, th, ph = coords[:, 0], coords[:, 1], coords[:, 2]
    return np.stack([r * np.sin(th) * np.cos(ph),
                     r * np.sin(th) * np.sin(ph),
                     r * np.cos(th)], axis=1)


def composite_kappa_cells(mesh: StructuredMesh, core_radius: float,
                          base: float, core: float,
                          radial_axes=(1, 2)) -> np.ndarray:
    """Per-sub-element diffusivity for a high-conductivity core.

    Marks a sub-simplex as core when all its vertices *and* its midpoint lie
    inside r < core_radius (DOLFIN SubDomain marking semantics with
    check_midpoint=True, matching fenics_mcp_server.py:541-550).  Replaces
    the reference's per-cell Python loop (:563-567) with vectorized tests.
    """
    origins = assembly._cell_origins(mesh)
    n_sub = len(mesh.subelems)
    out = np.full((n_sub,) + mesh.cell_shape, base, dtype=np.float64)
    for t, sub in enumerate(mesh.subelems):
        verts = mesh.subelem_vertices(t)  # [d+1, d] local
        inside = None
        pts = list(verts) + [verts.mean(axis=0)]
        for pt in pts:
            coords = [origins[a] + pt[a] for a in range(mesh.dim)]
            full = np.stack(np.broadcast_arrays(*coords), axis=-1)
            r = np.sqrt(sum(full[..., a] ** 2 for a in radial_axes))
            ok = r < core_radius
            inside = ok if inside is None else (inside & ok)
        out[t] = np.where(inside, core, base)
    return out


# ----------------------------------------------------------------------
# Per-face mixed boundary conditions (the _mixed heat tools; the _loaded
# elasticity tools resolve their face names here too)
# ----------------------------------------------------------------------

# face name → (axis, side) per dimension; x is the "length" axis, matching
# the reference's directional T_left/T_right convention
# (fenics_mcp_server.py:580-623)
_FACE_NAMES = {
    1: {"left": (0, 0), "right": (0, 1)},
    2: {"left": (0, 0), "right": (0, 1), "bottom": (1, 0), "top": (1, 1)},
    3: {"left": (0, 0), "right": (0, 1), "front": (1, 0), "back": (1, 1),
        "bottom": (2, 0), "top": (2, 1)},
}
_FACE_ALIASES = {"x_min": "left", "x_max": "right", "y_min": "bottom",
                 "y_max": "top", "z_min": "bottom", "z_max": "top",
                 "start": "left", "end": "right",
                 # wall/slab phrasing on Cartesian domains: inside → the
                 # x-low face, outside → the x-high face
                 "inner": "left", "inside": "left",
                 "outer": "right", "outside": "right"}


def _face_keys(dim: int, name: str):
    """Resolve a face name (or group: all/sides) to [(axis, side), ...]."""
    name = str(name).strip().lower()
    table = _FACE_NAMES[dim]
    if name in ("all", "boundary", "everywhere"):
        return list(table.values())
    if name in ("sides", "side", "lateral", "walls"):
        # every face except the two x faces (the reference's "side" notion)
        return [v for k, v in table.items() if k not in ("left", "right")]
    alias = _FACE_ALIASES.get(name, name)
    if dim == 2 and alias in ("front", "back"):  # tolerate 3D words in 2D
        alias = {"front": "bottom", "back": "top"}[alias]
    if dim == 3 and name == "y_min":
        alias = "front"
    if dim == 3 and name == "y_max":
        alias = "back"
    if alias not in table:
        raise ValueError(f"unknown face {name!r} for dim={dim}; "
                         f"expected one of {sorted(table)}")
    return [table[alias]]


def parse_face_bcs(boundary_conditions, dim: int):
    """Parse a per-face BC spec dict into solver inputs.

    Spec: ``{face: {"type": "dirichlet"|"robin"|"neumann"|"insulated", ...}}``
    where robin carries ``h`` + ``T_ambient`` (aliases ``t_inf``/``ambient``),
    neumann carries ``flux`` (inward W/m²; ``insulated`` ≡ flux 0), and a bare
    number is shorthand for a Dirichlet value.  A Dirichlet spec may add
    ``amplitude`` + ``period`` (or ``omega``) [+ ``phase``] for sinusoidal
    driving: T(t) = value + amplitude·sin(ωt+φ).  Unnamed faces default to
    the natural (insulated) condition.  Returns
    ``(dirichlet_list, robin_faces, flux_faces, modulated)`` with dirichlet
    entries as ``(axis, side, value)`` and modulated entries as
    ``(axis, side, amplitude, omega, phase)``.
    """
    dirichlet, robin, flux, modulated = [], [], [], []
    for face, spec in (boundary_conditions or {}).items():
        keys = _face_keys(dim, face)
        if isinstance(spec, (int, float)):
            spec = {"type": "dirichlet", "value": float(spec)}
        kind = str(spec.get("type", "dirichlet")).strip().lower()
        for axis, side in keys:
            if kind in ("dirichlet", "fixed", "temperature"):
                dirichlet.append((axis, side, float(spec.get("value", 0.0))))
                if spec.get("amplitude"):
                    omega = spec.get("omega")
                    if omega is None:
                        period = float(spec.get("period", 1.0))
                        omega = 2.0 * np.pi / period if period else 0.0
                    modulated.append((axis, side,
                                      float(spec["amplitude"]),
                                      float(omega),
                                      float(spec.get("phase", 0.0))))
            elif kind in ("robin", "convection", "convective"):
                t_inf = spec.get("T_ambient", spec.get("t_ambient",
                         spec.get("t_inf", spec.get("ambient", 0.0))))
                robin.append((axis, side, float(spec.get("h", 1.0)),
                              float(t_inf)))
            elif kind in ("neumann", "flux", "heat_flux"):
                flux.append((axis, side,
                             float(spec.get("flux", spec.get("value", 0.0)))))
            elif kind in ("insulated", "adiabatic", "natural"):
                pass  # natural BC: no term
            else:
                raise ValueError(f"unknown BC type {kind!r} for face {face!r}")
    return dirichlet, robin, flux, modulated
