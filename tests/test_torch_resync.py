"""The float32 MG-PCG with a true-residual resync every 16 iterations on the
16×8×8 cantilever, in the port and in the JAX package.

The port made a bf16 smoother copy on every float32 level, where the JAX
package makes one only on the levels its flat kernel takes (``pallas_wins``,
65,536 DOF and up); with that copy the port's loop stalled at relres 1.8e-3
for 200 iterations.  It now follows the reference's gate
(``multigrid.BF16_MIN_DOF``) and converges in both layouts.

What remains between the two packages' iteration counts is float32
summation order.  Each resync replaces the recurrence residual with b − A x
computed in float32, whose rounding on this ill-conditioned system sits
near relres 1e-2, so every window of 16 iterations restarts from there,
and a loop converges in the window where its recurrence first falls under
the tolerance before the next resync.  The JAX package's own loop, with
its dot products summed in other orders, lands in other windows, as far
from its 46 iterations as the port's layouts do."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from test_torch_device_loop import _cantilever, _carry, _heat, _rel

TOL, MAXITER, RESYNC = 1e-5, 200, 16
# x of the float32 cantilever against the JAX package's, ·max|x|: what its
# conditioning leaves of a 1e-5 relres (test_torch_device_loop's bound)
X_TOL = 1e-3
# the float32 summation orders the JAX package's loop is run with: its own
# ``vdot``, and sums of 256- and 512-element partial sums
CHUNKS = (None, 256, 512)


@pytest.fixture(scope="module")
def case():
    mesh, sysm, builder = _cantilever()
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32)
    return h_ref, sysm.b_hat.astype(np.float32)


def _port(h_ref, b32, layout):
    """The port's loop on the carried hierarchy: "flat" is the shipped
    layout (every level on the flat operator), "grid" every level on plain
    grid tensors."""
    with pytest.MonkeyPatch.context() as m:
        if layout == "grid":
            m.setattr(sk, "KERNEL_MIN_DOF", 10 ** 9)
        h = _carry(h_ref)
    b = torch.from_numpy(b32)
    x, k, relres = mg.mg_pcg(h, b, torch.zeros_like(b), TOL, MAXITER,
                             resync_every=RESYNC)
    return h, x, k, relres


def _chunked_vdot(chunk):
    def vdot(a, c):
        v = (a * c).reshape(-1)
        v = jnp.pad(v, (0, (-v.size) % chunk))
        return jnp.sum(jnp.sum(v.reshape(-1, chunk), axis=0))
    return vdot


def _reference(h_ref, b32, chunk):
    """The JAX package's ``mg_pcg``, its dots summed from ``chunk``-element
    partial sums (None: its own ``jnp.vdot``)."""
    with pytest.MonkeyPatch.context() as m:
        if chunk is not None:
            real = ref_mg.jnp
            proxy = types.SimpleNamespace(**{k: getattr(real, k)
                                             for k in dir(real)
                                             if not k.startswith("__")})
            proxy.vdot = _chunked_vdot(chunk)
            m.setattr(ref_mg, "jnp", proxy)
        xr, kr, rr = ref_mg.mg_pcg(h_ref, jnp.asarray(b32),
                                   jnp.zeros(b32.shape, jnp.float32), TOL,
                                   MAXITER, resync_every=RESYNC)
    return np.asarray(xr), int(kr), float(rr)


@pytest.mark.parametrize("layout", ["flat", "grid"])
def test_float32_cantilever_with_resync_converges(case, layout):
    """The case the bf16 copy on small levels stalled: the port converges
    to the tolerance in both layouts, with no bf16 copy on any of the
    cantilever's levels (all under 65,536 DOF), x within the cantilever's
    bound of the JAX package's."""
    h_ref, b32 = case
    h, x, k, relres = _port(h_ref, b32, layout)
    assert all(lv.w_lo is None for lv in h.levels)
    assert relres <= TOL and k < MAXITER, (k, relres)
    xr, kr, rr = _reference(h_ref, b32, None)
    assert rr <= TOL and kr < MAXITER
    assert _rel(x, xr) <= X_TOL


def test_resync_iteration_count_is_float32_summation_order(case):
    """The JAX package's own loop, its dots summed in other float32 orders,
    converges in windows at least one resync period apart, and each of the
    port's layouts lands within 2 iterations of one of those counts."""
    h_ref, b32 = case
    ref_counts = []
    for chunk in CHUNKS:
        _, kr, rr = _reference(h_ref, b32, chunk)
        assert rr <= TOL and kr < MAXITER, (chunk, kr, rr)
        ref_counts.append(kr)
    assert max(ref_counts) - min(ref_counts) >= RESYNC, ref_counts
    for layout in ("flat", "grid"):
        _, _, k, _ = _port(h_ref, b32, layout)
        assert min(abs(k - kr) for kr in ref_counts) <= 2, (layout, k,
                                                            ref_counts)


def test_bf16_copy_only_from_the_gate():
    """A dense hierarchy straddling 65,536 DOF (65×33×33 = 70,785 nodes,
    then 9,537 and below): the bf16 smoother copy on the fine level only;
    every level keeps the flat operator with float32 weights, and the
    levels under the gate smooth with it."""
    from pde_solver_tpu.mesh import box_mesh
    from pde_solver_tpu.ops import assembly
    from pde_solver_tpu.ops.bc import DirichletBC
    from pde_solver_tpu.ops.linsolve import prepare_system

    mesh = box_mesh(64, 32, 32, (0, 0, 0), (2.0, 1.0, 1.0))

    def builder(mc):
        K = assembly.assemble_scalar_stencil(mc, "stiffness")
        M = assembly.assemble_scalar_stencil(mc, "mass")
        A = {o: M.get(o, 0.0) + 0.01 * K.get(o, 0.0)
             for o in set(K) | set(M)}
        return A, DirichletBC.from_masks([(mc.boundary_mask(), 0.0)],
                                         mc.node_shape)

    A, bc = builder(mesh)
    sysm = prepare_system(A, mesh, bc, np.zeros(mesh.node_shape), 1)
    h = mg.build_hierarchy(mesh, sysm, builder, vdim=1, device="cpu")
    assert mg.BF16_MIN_DOF == 65536 and len(h.levels) >= 3
    for i, lv in enumerate(h.levels):
        assert isinstance(lv.weights, sk.FlatStencilOperator)
        assert lv.weights.W.dtype == torch.float32
        if i == 0:
            assert lv.w_lo.W.dtype == torch.bfloat16
        else:
            assert lv.w_lo is None and lv.w_smooth is lv.weights


def test_heat_resync_unchanged_by_the_gate():
    """The well-conditioned heat operator (17³, every level under the
    gate) takes the JAX package's iterations ±1 with resync, as before."""
    mesh, sysm, builder = _heat()
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=1,
                                   dtype=jnp.float32)
    h = _carry(h_ref)
    b32 = sysm.b_hat.astype(np.float32)
    b = torch.from_numpy(b32)
    x, k, relres = mg.mg_pcg(h, b, torch.zeros_like(b), 1e-6, 200,
                             resync_every=RESYNC)
    xr, kr, _ = ref_mg.mg_pcg(h_ref, jnp.asarray(b32), jnp.zeros_like(b32),
                              1e-6, 200, resync_every=RESYNC)
    assert relres <= 1e-6 and abs(k - int(kr)) <= 1, (k, int(kr))
    assert _rel(x, xr) <= 1e-6
