"""Reference of the 3D heat tool on a box: the P1 θ-scheme, plain.

Per step, on the free nodes: (M + θΔtκK) uⁿ⁺¹ = (M − (1−θ)ΔtκK) uⁿ −
(M + θΔtκK) g, and uⁿ⁺¹ = g on the Dirichlet nodes, with M the consistent
mass and K the stiffness of P1 on the Kuhn split of the box.  Dirichlet
data of the directional form: ``T_left`` on x = 0, ``T_right`` on x = Lx,
``T_side`` on the other faces less those two; the initial field is
``T_initial`` on the free nodes.  Each step is solved by multigrid-PCG
(:mod:`p1`) to a true relative residual of ``tol``, warm-started from the
step before.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .p1 import (Grid, Multigrid, StencilOperator, face_mask, mass_matrices,
                pcg, stiffness_matrices, to_flat)

FACES = ("x0", "x1", "y0", "y1", "z0", "z1")


def frame_steps(num_steps: int, max_frames: int) -> list:
    """The steps whose state the tool keeps besides the initial one: every
    k-th with k = ⌈steps / max_frames⌉ (every step when no cap), and the
    last."""
    k = max(1, -(-num_steps // max_frames)) if max_frames > 0 else 1
    steps = list(range(k, num_steps + 1, k))
    if not steps or steps[-1] != num_steps:
        steps.append(num_steps)
    return steps


def dirichlet(grid: Grid, T_left, T_right, T_side, dtype, device):
    g = torch.zeros(grid.nodes, dtype=dtype, device=device)
    for f in ("y0", "y1", "z0", "z1"):
        g[face_mask(grid, [f], device)] = float(T_side)
    g[0] = float(T_left)
    g[-1] = float(T_right)
    return g[None]


def trajectory(config: Dict, request: Dict, device, dtype=torch.float64,
               tol: float = 1e-11, maxiter: int = 400) -> Dict:
    """The kept frames of one request, flat and float64: {"times": [Nt],
    "values": [Nt, N], "iterations", "worst_relres"}."""
    mesh = config["mesh"]
    grid = Grid(tuple(mesh["cells"]), tuple(mesh["extent"]))
    kappa = float(request.get("diffusivity", config["tool_args"].get(
        "diffusivity", 1.0)))
    dt = float(request.get("dt", config["tool_args"]["dt"]))
    steps = int(request.get("num_steps", config["tool_args"]["num_steps"]))
    theta = float(config.get("theta", 1.0))

    def elem(spacing, sign_theta):
        return (mass_matrices(spacing)
                + sign_theta * dt * kappa * stiffness_matrices(spacing))

    def constrained(g):
        return face_mask(g, FACES, device)

    mg = Multigrid(grid, lambda g: StencilOperator(g, elem(g.spacing, theta),
                                                   dtype, device),
                   constrained, dtype, device)
    A = mg.fine
    B = StencilOperator(grid, elem(grid.spacing, -(1.0 - theta)), dtype,
                        device)
    g = dirichlet(grid, request["T_left"], request["T_right"],
                  request["T_side"], dtype, device)
    Ag = A.op(g)
    u = A.free * float(request["T_initial"]) + A.fixed * g
    keep = set(frame_steps(steps, int(config["config_overrides"].get(
        "snapshot_max_frames", 0))))
    frames, times = [to_flat(u[0])], [0.0]
    iters, worst = 0, 0.0
    for n in range(1, steps + 1):
        rhs = A.free * (B(u) - Ag) + A.fixed * g
        u, it, rel = pcg(A, mg, rhs, u, tol, maxiter)
        iters += it
        worst = max(worst, rel)
        if n in keep:
            frames.append(to_flat(u[0]))
            times.append(dt * n)
    return {"times": np.asarray(times), "values": np.stack(frames),
            "iterations": iters, "worst_relres": worst}
