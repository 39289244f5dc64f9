"""Carry solver state from the JAX package into this port, as numpy.

With these, a test runs both packages on the identical operator — the MG
relaxation weight ω included (the port's own float32 power iteration gives
an ω that differs at the 1e-7 level).  Takes numpy only: this module, like
the rest of the port, never imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from pde_solver_tpu_torch.ops.linsolve import ScaledSystem
from pde_solver_tpu_torch.ops.multigrid import (MGHierarchy, _ShapeOnlyMesh,
                                                _to_level,
                                                _with_coarsest_inverse)
from pde_solver_tpu_torch.ops.stencil_kernels import FlatStencilOperator


def flat_operator_from_packed(Wf_np: np.ndarray, offsets, node_shape,
                              vdim: int, device) -> FlatStencilOperator:
    """Operator from the JAX package's packed ``FlatStencilOperator.Wf``
    (``[n_off·v·v, n_rows, 128]``, zero tail past N): the first N entries of
    each plane are exactly this port's plane-major ``[n_off·v·v, N]``."""
    N = int(np.prod(node_shape))
    planes = np.asarray(Wf_np).reshape(Wf_np.shape[0], -1)[:, :N]
    W = torch.from_numpy(np.ascontiguousarray(planes, dtype=np.float32))
    return FlatStencilOperator.from_packed(W.to(device), offsets, node_shape,
                                           vdim)


def hierarchy_from_numpy(levels: Sequence[Mapping], grid_dim: int, vdim: int,
                         pre_smooth: int = 2, post_smooth: int = 2,
                         coarse_iters: int = 60, device="cuda"
                         ) -> MGHierarchy:
    """Hierarchy from per-level numpy state of a JAX-package ``MGHierarchy``.

    Each level maps ``offsets``, ``weights`` (per-offset f64 arrays, i.e.
    ``MGLevel.host_weights``), ``free``, ``omega`` and either ``s`` or
    ``C`` and ``Cinv`` (``MGLevel.host_scale``); the coarsest may carry
    ``host_Ainv``.  Operators are built exactly as ``build_hierarchy``
    builds them, with the given ω instead of a fresh power iteration."""
    out = []
    for lv in levels:
        free = np.asarray(lv["free"], np.float64)
        node_shape = free.shape[:grid_dim]
        if "s" in lv:
            sysm = ScaledSystem(tuple(lv["offsets"]), list(lv["weights"]),
                                None, None, free, "scalar",
                                np.asarray(lv["s"]), None, None)
        else:
            sysm = ScaledSystem(tuple(lv["offsets"]), list(lv["weights"]),
                                None, None, free, "block", None,
                                np.swapaxes(np.asarray(lv["C"]), -1, -2),
                                np.swapaxes(np.asarray(lv["Cinv"]), -1, -2))
        out.append(_to_level(sysm, _ShapeOnlyMesh(node_shape), vdim, device,
                             omega=float(lv["omega"])))
    host_Ainv = levels[-1].get("host_Ainv")
    if host_Ainv is not None:
        out = _with_coarsest_inverse(out, np.asarray(host_Ainv, np.float64),
                                     device)
    return MGHierarchy(tuple(out), grid_dim, vdim, pre_smooth, post_smooth,
                       coarse_iters)
