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

from pde_solver_tpu_torch.ops.cs_kernels import (CSFlatStencilOperator,
                                                 _masks_np)
from pde_solver_tpu_torch.ops.linsolve import ScaledSystem
from pde_solver_tpu_torch.ops.multigrid import (MGHierarchy, _ShapeOnlyMesh,
                                                _to_level,
                                                _with_coarsest_inverse)
from pde_solver_tpu_torch.ops.stencil_kernels import (FlatStencilOperator,
                                                      padded_length)


def flat_operator_from_packed(Wf_np: np.ndarray, offsets, node_shape,
                              vdim: int, device) -> FlatStencilOperator:
    """Operator from the JAX package's packed ``FlatStencilOperator.Wf``
    (``[n_off·v·v, n_rows, 128]``, zero tail past N): the first N_pad
    entries of each plane, zero tail included, are exactly this port's
    plane-major ``[n_off·v·v, N_pad]``."""
    N_pad = padded_length(int(np.prod(node_shape)))
    planes = np.asarray(Wf_np).reshape(Wf_np.shape[0], -1)[:, :N_pad]
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


def _descs_from_masks(masks: np.ndarray, node_shape) -> list:
    """Class descriptors of the reference's mask planes (its validity plane,
    the last, dropped): each plane equals the plane of exactly one layer
    ("ax", axis, c) or edge line ("pair", ay, az, cy, cz) of the two minor
    axes."""
    d = len(node_shape)
    N = int(np.prod(node_shape))
    planes = np.asarray(masks).reshape(np.shape(masks)[0], -1)[:-1, :N]
    fold = list(range(max(0, d - 2), d))
    layers = {ax: sorted({0, 1, int(node_shape[ax]) - 2,
                          int(node_shape[ax]) - 1}) for ax in fold}
    cands = [("ax", ax, c) for ax in fold for c in layers[ax]]
    if len(fold) == 2:
        ay, az = fold
        cands += [("pair", ay, az, cy, cz)
                  for cy in layers[ay] for cz in layers[az]]
    cand_planes = _masks_np(cands, node_shape, N)
    descs = []
    for plane in planes:
        hits = [c for c, cp in zip(cands, cand_planes)
                if np.array_equal(cp, plane)]
        if len(hits) != 1:
            raise ValueError("a mask plane matches no single boundary class")
        descs.append(hits[0])
    return descs


def cs_operator_from_reference(sets, win_octs, Wwin, masks, offsets,
                               node_shape, vdim: int,
                               device="cuda") -> CSFlatStencilOperator:
    """Operator from a JAX-package ``CSFlatStencilOperator``'s artifacts:
    its scalar ``sets``, octet list ``win_octs``, residual weights ``Wwin``
    (``[n_off·v², n_win·8, 128]``) and class ``masks`` (``[n_sets, n_rows,
    128]``, validity plane last).  An octet is one of this port's 1024-node
    windows, so the list and the weights carry over unchanged."""
    nw = len(offsets) * vdim * vdim
    return CSFlatStencilOperator(
        offsets, node_shape, vdim, sets, _descs_from_masks(masks, node_shape),
        np.asarray(win_octs, np.int64),
        np.asarray(Wwin, np.float32).reshape(nw, -1), device=device)
