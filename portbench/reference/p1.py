"""Plain P1 finite elements on a structured box, for the benchmark's
reference solutions.

Written from the weak forms, in plain PyTorch, and independent of the
program under test: it imports nothing of it.  The mesh is the box split
into grid cells, each cut into the six Kuhn (Freudenthal) tetrahedra that
share the cell's main diagonal, the split DOLFIN's ``BoxMesh`` makes.  An
operator is assembled into one weight array per node offset (the P1
couplings of that split reach 15 offsets) and applied by shifted slices.

Solves are preconditioned CG with a geometric multigrid V-cycle of its
own (coarse operators re-assembled on the halved mesh, P1 interpolation
between the nested meshes, Chebyshev-Jacobi smoothing, a dense coarsest
solve).  The preconditioner only sets the speed: a solve ends when the
true residual of the assembled operator meets its tolerance.

Tensors are component first: a field of ``v`` components on a grid of
``nodes`` = (nx+1, ny+1, nz+1) is ``[v, nx+1, ny+1, nz+1]``, x first.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# One tetrahedron per monotone lattice path from (0,0,0) to (1,1,1).
TETS = tuple(
    tuple(tuple(int(a in perm[:k]) for a in range(3)) for k in range(4))
    for perm in itertools.permutations(range(3)))


def tet_geometry(spacing: Sequence[float]):
    """Per tetrahedron of a cell: (volume, basis gradients [4, 3])."""
    out = []
    for verts in TETS:
        V = np.asarray(verts, np.float64) * np.asarray(spacing, np.float64)
        J = (V[1:] - V[0]).T                     # columns: edge vectors
        vol = abs(np.linalg.det(J)) / 6.0
        Jinv = np.linalg.inv(J)                  # row i: grad of phi_{i+1}
        grads = np.vstack([-Jinv.sum(axis=0), Jinv])
        out.append((vol, grads))
    return out


def mass_matrices(spacing) -> np.ndarray:
    """[6, 4, 1, 4, 1]: ∫ φ_a φ_b = |T| (1 + δ_ab) / 20."""
    out = []
    for vol, _ in tet_geometry(spacing):
        out.append(vol / 20.0 * (np.ones((4, 4)) + np.eye(4)))
    return np.asarray(out)[:, :, None, :, None]


def stiffness_matrices(spacing) -> np.ndarray:
    """[6, 4, 1, 4, 1]: ∫ ∇φ_a · ∇φ_b = |T| g_a · g_b."""
    out = [vol * g @ g.T for vol, g in tet_geometry(spacing)]
    return np.asarray(out)[:, :, None, :, None]


def strain_matrix(grads: np.ndarray) -> np.ndarray:
    """Voigt B [6, 12] (εxx, εyy, εzz, γyz, γxz, γxy) of a tetrahedron,
    columns node-major (node a, component i) → 3a + i."""
    B = np.zeros((6, 12))
    for a in range(4):
        gx, gy, gz = grads[a]
        c = 3 * a
        B[0, c] = gx
        B[1, c + 1] = gy
        B[2, c + 2] = gz
        B[3, c + 1], B[3, c + 2] = gz, gy
        B[4, c], B[4, c + 2] = gz, gx
        B[5, c], B[5, c + 1] = gy, gx
    return B


def elasticity_moduli(lam: float, mu: float) -> np.ndarray:
    """Isotropic D [6, 6] on engineering Voigt strains."""
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2.0 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    return D


def elasticity_matrices(spacing, lam: float, mu: float) -> np.ndarray:
    """[6, 4, 3, 4, 3]: ∫ σ(φ_b e_j) : ε(φ_a e_i) = |T| (Bᵀ D B)."""
    D = elasticity_moduli(lam, mu)
    out = []
    for vol, g in tet_geometry(spacing):
        B = strain_matrix(g)
        out.append((vol * B.T @ D @ B).reshape(4, 3, 4, 3))
    return np.asarray(out)


def lame(E: float, nu: float) -> Tuple[float, float]:
    return (E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), E / (2.0 * (1.0 + nu)))


OFFSETS = tuple(sorted({tuple(b - a for a, b in zip(va, vb))
                        for verts in TETS for va in verts for vb in verts}))


@dataclass
class Grid:
    cells: Tuple[int, int, int]
    extent: Tuple[float, float, float]

    @property
    def nodes(self) -> Tuple[int, int, int]:
        return tuple(c + 1 for c in self.cells)

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(e / c for e, c in zip(self.extent, self.cells))

    def coarser(self) -> Optional["Grid"]:
        """The grid with every axis halved, or None where one cannot be."""
        if any(c % 2 or c < 4 for c in self.cells):
            return None
        return Grid(tuple(c // 2 for c in self.cells), self.extent)


def face_mask(grid: Grid, faces: Sequence[str], device) -> torch.Tensor:
    """Bool [nodes] of the nodes on the named faces ("x0", "z1", ...)."""
    m = torch.zeros(grid.nodes, dtype=torch.bool, device=device)
    for f in faces:
        a, side = "xyz".index(f[0]), int(f[1])
        idx = [slice(None)] * 3
        idx[a] = -1 if side else 0
        m[tuple(idx)] = True
    return m


def cell_region(delta, cells):
    return tuple(slice(d, d + n) for d, n in zip(delta, cells))


class StencilOperator:
    """Σ over tetrahedra of constant element matrices, assembled into
    weights ``W[o]`` [v, v, *nodes]: (A x)[n] = Σ_o W[o][n] x[n + o]."""

    def __init__(self, grid: Grid, elem: np.ndarray, dtype, device):
        self.grid, self.dtype, self.device = grid, dtype, device
        v = elem.shape[2]
        self.v = v
        cells, nodes = grid.cells, grid.nodes
        W = torch.zeros((len(OFFSETS), v, v) + nodes, dtype=torch.float64,
                        device=device)
        index = {o: k for k, o in enumerate(OFFSETS)}
        Ke = torch.as_tensor(elem, dtype=torch.float64, device=device)
        for t, verts in enumerate(TETS):
            for a, va in enumerate(verts):
                for b, vb in enumerate(verts):
                    o = tuple(q - p for p, q in zip(va, vb))
                    W[(index[o], slice(None), slice(None))
                      + cell_region(va, cells)] += Ke[t, a, :, b, :,
                                                      None, None, None]
        self.W = W.to(dtype)
        self._pad = torch.zeros((v,) + tuple(n + 2 for n in nodes),
                                dtype=dtype, device=device)

    def diagonal(self) -> torch.Tensor:
        k = OFFSETS.index((0, 0, 0))
        return torch.diagonal(self.W[k], dim1=0, dim2=1).movedim(-1, 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nodes = self.grid.nodes
        inner = tuple(slice(1, 1 + n) for n in nodes)
        self._pad[(slice(None),) + inner] = x
        y = torch.zeros_like(x)
        for k, o in enumerate(OFFSETS):
            xs = self._pad[(slice(None),) + tuple(
                slice(1 + d, 1 + d + n) for d, n in zip(o, nodes))]
            if self.v == 1:
                y.addcmul_(self.W[k, 0], xs)
            else:
                y += (self.W[k] * xs[None]).sum(1)
        return y


class MaskedOperator:
    """The operator on the free nodes, identity on the constrained ones:
    F ⊙ A(F ⊙ x) + (1 − F) ⊙ x, with F the free mask per component."""

    def __init__(self, op: StencilOperator, constrained: torch.Tensor):
        self.op = op
        v = op.v
        self.free = (~constrained).to(op.dtype).expand((v,) + op.grid.nodes)
        self.fixed = 1.0 - self.free

    def __call__(self, x):
        return self.free * self.op(self.free * x) + self.fixed * x

    def diagonal(self):
        return self.free * self.op.diagonal() + self.fixed


def prolong(xc: torch.Tensor, fine_nodes) -> torch.Tensor:
    """P1 interpolation from the halved grid: a fine node that is not a
    coarse one is the midpoint of the coarse Kuhn edge from (i, j, k) to
    (i, j, k) + (a, b, c), every such edge running in a 0/1 direction."""
    xf = torch.zeros(xc.shape[:1] + tuple(fine_nodes), dtype=xc.dtype,
                     device=xc.device)
    nc = xc.shape[1:]
    for abc in itertools.product((0, 1), repeat=3):
        n = tuple(m - s for m, s in zip(nc, abc))
        lo = xc[(slice(None),) + tuple(slice(0, k) for k in n)]
        fine = (slice(None),) + tuple(slice(s, None, 2) for s in abc)
        if abc == (0, 0, 0):
            xf[fine] = lo
        else:
            hi = xc[(slice(None),) + tuple(slice(s, s + k)
                                            for s, k in zip(abc, n))]
            xf[fine] = 0.5 * (lo + hi)
    return xf


def restrict(xf: torch.Tensor, coarse_nodes) -> torch.Tensor:
    """The transpose of :func:`prolong`."""
    xc = torch.zeros(xf.shape[:1] + tuple(coarse_nodes), dtype=xf.dtype,
                     device=xf.device)
    for abc in itertools.product((0, 1), repeat=3):
        n = tuple(m - s for m, s in zip(coarse_nodes, abc))
        part = xf[(slice(None),) + tuple(slice(s, None, 2) for s in abc)]
        lo = (slice(None),) + tuple(slice(0, k) for k in n)
        if abc == (0, 0, 0):
            xc[lo] += part
        else:
            hi = (slice(None),) + tuple(slice(s, s + k)
                                        for s, k in zip(abc, n))
            xc[lo] += 0.5 * part
            xc[hi] += 0.5 * part
    return xc


class Level:
    def __init__(self, grid, A: MaskedOperator):
        self.grid, self.A = grid, A
        self.dinv = 1.0 / A.diagonal()
        self.lmax = 1.1 * _power_lmax(A, self.dinv)


def _power_lmax(A, dinv, iters: int = 15) -> float:
    gen = torch.Generator(device="cpu").manual_seed(1234)
    x = torch.rand(dinv.shape, generator=gen, dtype=torch.float64).to(
        dinv.device, dinv.dtype)
    lam = 1.0
    for _ in range(iters):
        y = dinv * A(x)
        lam = float(torch.linalg.vector_norm(y.float()))
        x = y / lam
    return lam


def chebyshev(level: Level, b, x=None, degree: int = 3, ratio: float = 0.1):
    """``degree`` Chebyshev-Jacobi steps on [ratio·λmax, λmax], from x
    (zero where None)."""
    A, dinv = level.A, level.dinv
    lmax = level.lmax
    lmin = ratio * lmax
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b if x is None else b - A(x)
    d = dinv * r / theta
    x = torch.zeros_like(b) if x is None else x
    for k in range(degree):
        x = x + d
        if k == degree - 1:
            break
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
        rho = rho_new
    return x


class Multigrid:
    """A symmetric V-cycle over the halvings of ``grid``.

    ``make_op(grid)`` gives the level's assembled operator and
    ``constrained(grid)`` its Dirichlet nodes."""

    def __init__(self, grid: Grid, make_op: Callable, constrained: Callable,
                 dtype, device):
        self.levels: List[Level] = []
        g = grid
        while g is not None:
            A = MaskedOperator(make_op(g), constrained(g))
            self.levels.append(Level(g, A))
            g = g.coarser()
        last = self.levels[-1]
        n = last.A.free.numel()
        eye = torch.eye(n, dtype=torch.float64, device=device)
        shape = last.A.free.shape
        cols = [last.A(eye[i].reshape(shape).to(dtype)).reshape(-1)
                for i in range(n)]
        dense = torch.stack(cols, 1).to(torch.float64)
        self.coarse = torch.linalg.cholesky(0.5 * (dense + dense.T))
        self.dtype = dtype

    @property
    def fine(self) -> MaskedOperator:
        return self.levels[0].A

    def _solve_coarse(self, b):
        shape = b.shape
        x = torch.cholesky_solve(b.reshape(-1, 1).to(torch.float64),
                                 self.coarse)
        return x.reshape(shape).to(b.dtype)

    def _cycle(self, k: int, b):
        if k == len(self.levels) - 1:
            return self._solve_coarse(b)
        lev, nxt = self.levels[k], self.levels[k + 1]
        x = chebyshev(lev, b)
        r = b - lev.A(x)
        rc = nxt.A.free * restrict(r, nxt.grid.nodes)
        xc = self._cycle(k + 1, rc)
        x = x + lev.A.free * prolong(xc, lev.grid.nodes)
        return chebyshev(lev, b, x)

    def __call__(self, r):
        return self._cycle(0, r)


def pcg(A, M, b, x, tol: float, maxiter: int):
    """Preconditioned CG from x, until the recursive residual is at most
    tol ‖b‖ or after ``maxiter`` iterations.  Returns (x, iterations, true
    relative residual ‖b − A x‖ / ‖b‖).  Where rounding sets a floor on
    the true residual (ε‖A‖‖x‖ of an ill-conditioned system), it is
    reported as it is."""
    bn = float(torch.linalg.vector_norm(b.double()))
    if bn == 0.0:
        return torch.zeros_like(b), 0, 0.0
    r = b - A(x)
    z = M(r)
    p, rz = z, torch.sum(r * z)
    it = 0
    while (it < maxiter
           and float(torch.linalg.vector_norm(r.double())) > tol * bn):
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        it += 1
        z = M(r)
        rz_new = torch.sum(r * z)
        p, rz = z + (rz_new / rz) * p, rz_new
    return x, it, float(torch.linalg.vector_norm((b - A(x)).double())) / bn


def to_flat(u: torch.Tensor) -> np.ndarray:
    """[*nodes] → the tools' flat node order (x fastest), float64 numpy."""
    return u.permute(2, 1, 0).reshape(-1).double().cpu().numpy()
