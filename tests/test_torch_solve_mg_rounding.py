"""The unsharded float64 ``solve_mg`` on the gravity-loaded cantilever at
64×8×8 cells: 34 iterations in the JAX package, 38 in the port as its
dots run on several threads (``tests/test_torch_parallel.py``), on the
same levels (bit-equal weights, ω within 1e-14).

Side by side the two loops agree to rounding (‖r‖ within 1e-10
relative) for 15 iterations and part at the 16th, the first true-residual
resync: r = b̂ − Â x̂ cancels ‖b̂‖ down to 5e-5 of itself, so the two
packages' float64 roundings of that apply (their stencil sums and dots in
other orders) come out 1e-9 apart.  The tolerance, 1e-11, sits at the
float64 floor of the recomputed residual, so the iteration at which ‖r‖
first falls under it is decided by rounding: the port's count moves with
the number of threads its BLAS dot splits a sum over, and the JAX
package's own loop, its dot products summed in other orders, lands from
34 to 38.  Nothing in either loop is at fault, and the fields agree within
the 1e-9 parity bound.  The port runs on one thread here (a fixed order
on any host, and its small operations run fastest so)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import linsolve as ref_linsolve
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.ops import assembly, linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops.bc import DirichletBC

CELLS = (64, 8, 8)
TOL, MAXITER = 1e-11, 200     # the "f64" branch's cfg.tol
E, NU = 210e9, 0.3
LAM, MU = E * NU / ((1 + NU) * (1 - 2 * NU)), E / (2 * (1 + NU))
REF = 34                      # the JAX package's iterations
PORT = 38                     # the port's, its dots on several threads
RESYNC = 16                   # mg_pcg's resync_every (both packages)


def _system(mk, asm, BC, prep):
    mesh = mk(*CELLS, (0, 0, 0), (1.0, 0.2, 0.2))

    def make(m):
        return (asm.assemble_elasticity_stencil(m, LAM, MU),
                BC.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape,
                              vdim=3))

    K, bc = make(mesh)
    b = asm.assemble_vector_load(mesh, np.array([0.0, 0.0, -9.81 * 7800]))
    return mesh, prep(K, mesh, bc, b, 3), make


@pytest.fixture(scope="module")
def case():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _case()
    finally:
        torch.set_num_threads(threads)


def _case():
    mesh, sysm, make = _system(box_mesh, assembly, DirichletBC,
                               linsolve.prepare_system)
    rmesh, rsys, rmake = _system(ref_mesh.box_mesh, ref_asm, RefBC,
                                 ref_linsolve.prepare_system)
    h = mg.build_hierarchy(mesh, sysm, make, vdim=3, device="cpu",
                           dtype=torch.float64)
    h_ref = ref_mg.build_hierarchy(rmesh, rsys, rmake, vdim=3,
                                   dtype=jnp.float64)
    assert np.array_equal(sysm.b_hat, rsys.b_hat)
    return h, h_ref, sysm.b_hat, mg.solve_mg(h, sysm.b_hat, None, TOL,
                                             MAXITER)


def _without_ainv(h):
    return h._replace(levels=tuple(lv._replace(Ainv=None)
                                   for lv in h.levels))


def _port_relres(h, b_hat, n):
    """‖r‖/‖b̂‖ after each of the port's first n iterations: its own masked
    program (``multigrid._pcg_program``), stepped one iteration at a
    time."""
    prologue, step, status, _ = mg._pcg_program(_without_ainv(h), RESYNC)
    b = torch.as_tensor(b_hat)
    state = prologue(b, torch.zeros_like(b), torch.tensor(TOL,
                                                          dtype=torch.float64),
                     torch.tensor(MAXITER))
    out = []
    for g in range(n):
        state = step(state, g)
        out.append(float(status(state)[2]))
    return out


def _vdot_in(chunk, reverse=False):
    """A float64 dot summed from ``chunk``-element partial sums (of the
    vector reversed with ``reverse``)."""
    def vdot(a, c):
        v = (a * c).reshape(-1)
        if reverse:
            v = v[::-1]
        v = jnp.pad(v, (0, (-v.size) % chunk))
        return jnp.sum(jnp.sum(v.reshape(-1, chunk), axis=0))
    return vdot


def _reference_in(h_ref, b_hat, vdot):
    """The JAX package's own ``mg_pcg`` (jitted, no coarsest inverse, as
    its ``solve_mg`` runs it) with its dot products summed by ``vdot``."""
    real = ref_mg.jnp
    proxy = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                     if not k.startswith("__")})
    proxy.vdot = vdot
    h0 = _without_ainv(h_ref)
    b = jnp.asarray(b_hat)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ref_mg, "jnp", proxy)
        x, k, _ = jax.jit(lambda b: ref_mg.mg_pcg(h0, b, jnp.zeros_like(b),
                                                  TOL, MAXITER))(b)
    return np.asarray(x), int(k)


def test_loops_part_at_the_first_resync(case):
    """The JAX package's ``solve_mg`` takes 34 iterations, the port's from
    35 to 38 (36 on one thread), on levels that agree (weights bit for
    bit, ω to 1e-14).  Iteration by iteration the relres of the two loops
    agrees within 1e-10 for 15 iterations and parts at the 16th, the first
    resync."""
    h, h_ref, b_hat, (xh, k, relres) = case
    for lv, lv_ref in zip(h.levels, h_ref.levels):
        assert all(np.array_equal(W.numpy(), np.asarray(W_ref))
                   for W, W_ref in zip(lv.weights, lv_ref.host_weights))
        assert abs(lv.omega - lv_ref.omega) <= 1e-14 * lv_ref.omega
    xh_ref, k_ref, relres_ref = ref_mg.solve_mg(h_ref, b_hat, None, TOL,
                                                MAXITER)
    assert int(k_ref) == REF and 0 < abs(k - REF) <= PORT - REF
    assert relres <= TOL and float(relres_ref) <= TOL
    gap = np.abs(xh.numpy() - np.asarray(xh_ref)).max()
    assert gap <= 1e-9 * np.abs(np.asarray(xh_ref)).max()

    port = _port_relres(h, b_hat, RESYNC)
    ref = [float(ref_mg.solve_mg(h_ref, b_hat, None, TOL, n)[2])
           for n in (RESYNC - 1, RESYNC)]
    rel = [abs(p - r) / r for p, r in zip(port[-2:], ref)]
    # the relres of the 15th iteration carries every earlier one's rounding
    assert rel[0] <= 1e-10 < rel[1], rel


def test_other_summation_orders_land_as_far(case):
    """The JAX package's own loop with its dot products summed in other
    float64 orders takes 36 (partial sums of 2,048) and 38 (the vector
    reversed, partial sums of 1,000) iterations, as far from its 34 as
    the port's 38, and as the port's count here; the port's loop with its
    dots in partial sums of 2,048 takes the JAX package's 34.  Every field
    lies within 1e-9 of the JAX package's."""
    h, h_ref, b_hat, (_, k_port, _) = case
    x34, k = _reference_in(h_ref, b_hat, jnp.vdot)
    assert k == REF
    scale = np.abs(x34).max()
    for vdot, want in ((_vdot_in(2048), 36),
                       (_vdot_in(1000, reverse=True), PORT)):
        x, k = _reference_in(h_ref, b_hat, vdot)
        assert k == want and np.abs(x - x34).max() <= 1e-9 * scale
    assert abs(k_port - REF) <= PORT - REF

    def dot2048(a, c):
        v = (a * c).reshape(-1)
        v = torch.nn.functional.pad(v, (0, (-v.numel()) % 2048))
        return v.reshape(-1, 2048).sum(0).sum()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(mg, "_dot", dot2048)
        xh, k, _ = mg.solve_mg(h, b_hat, None, TOL, MAXITER)
    assert k == REF and np.abs(xh.numpy() - x34).max() <= 1e-9 * scale
