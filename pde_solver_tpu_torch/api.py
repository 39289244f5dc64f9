"""Public solver API of the port — the tools ported so far.

Names, signatures, defaults, artifact layout and result metadata match
``pde_solver_tpu.api`` exactly (tests compare ``inspect.signature``).  Every
``SolveResult.meta`` carries a ``solver_stats`` block (DOF count, CG
iterations, achieved residual, phase seconds).

The device and precision come from ``config.get_config()`` (scope them with
``config.config_overrides``).
"""

from __future__ import annotations

import numpy as np

from pde_solver_tpu_torch.fields import SolveResult, TimeSeriesField, save_field
from pde_solver_tpu_torch.mesh import StructuredMesh, box_mesh
from pde_solver_tpu_torch.models import elasticity as elast
from pde_solver_tpu_torch.models.heat import embed_identity3


def _pack(mesh: StructuredMesh, embed, times, values, dim, meta, stats) -> TimeSeriesField:
    coords = embed(mesh.flat_node_coords())
    meta = dict(meta)
    meta["solver_stats"] = stats
    return TimeSeriesField(coords=coords, values=np.asarray(values),
                           times=np.asarray(times), dim=dim, meta=meta)


def _result(field: TimeSeriesField, data_dir: str, prefix: str) -> SolveResult:
    path = save_field(field, data_dir, prefix)
    return SolveResult(data_file=path, dim=field.dim, meta=field.meta)


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
