"""Public solver API of the port — the tools ported so far.

Names, signatures, defaults, artifact layout and result metadata match
``pde_solver_tpu.api`` exactly (tests compare ``inspect.signature``).  Every
``SolveResult.meta`` carries a ``solver_stats`` block (DOF count, CG
iterations, achieved residual, phase seconds).

The device and precision come from ``config.get_config()`` (scope them with
``config.config_overrides``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pde_solver_tpu_torch.fields import SolveResult, TimeSeriesField, save_field
from pde_solver_tpu_torch.mesh import StructuredMesh, box_mesh
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models import heat
from pde_solver_tpu_torch.models.heat import embed_identity3, weight_r_yz


def _pack(mesh: StructuredMesh, embed, times, values, dim, meta, stats) -> TimeSeriesField:
    coords = embed(mesh.flat_node_coords())
    meta = dict(meta)
    meta["solver_stats"] = stats
    return TimeSeriesField(coords=coords, values=np.asarray(values),
                           times=np.asarray(times), dim=dim, meta=meta)


def _result(field: TimeSeriesField, data_dir: str, prefix: str) -> SolveResult:
    path = save_field(field, data_dir, prefix)
    return SolveResult(data_file=path, dim=field.dim, meta=field.meta)


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
    if quantity == "displacement":
        field_name, unit = "displacement_magnitude", "m"
    elif quantity == "strain":
        field_name, unit = "von_mises_strain", "-"
    else:
        field_name, unit = "von_mises_stress", "Pa"
    meta = {
        "name": field_name, "unit": unit, "pde": "elasticity_3d",
        "Lx": Lx, "Ly": Ly, "Lz": Lz, "E": E, "nu": nu,
        "body_fx": body_fx, "body_fy": body_fy, "body_fz": body_fz,
        "quantity": quantity,
    }
    field = _pack(mesh, embed_identity3, np.array([0.0]), values[None, :], 3,
                  meta, stats)
    return _result(field, data_dir, f"elasticity_3d_{quantity}")
