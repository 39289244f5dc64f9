"""Flat-stencil SpMV of the port against the JAX package's Pallas kernels.

On the CPU the port's ``FlatStencilOperator`` runs ``spmv_plain``; the JAX
operator runs its Pallas kernels in interpret mode, in both the resident and
the windowed form.  The CUDA kernel itself is checked against ``spmv_plain``
on the card by ``test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh as ref_box, rectangle_mesh as ref_rect
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops.bc import DirichletBC as RefBC, all_boundary
from pde_solver_tpu.ops.linsolve import np_stencil_apply, prepare_system
from pde_solver_tpu.ops.pallas_kernels import FlatStencilOperator as RefFlat
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.ops import linsolve as port_ls
from pde_solver_tpu_torch.ops import stencil_kernels as sk


def _system(vdim, mesh=None):
    mesh = mesh or ref_box(10, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5))
    if vdim == 1:
        K = ref_asm.assemble_scalar_stencil(mesh, "stiffness")
        bc = RefBC.from_masks([(all_boundary(mesh), 2.0)], mesh.node_shape)
        rhs = ref_asm.assemble_load(mesh)
    else:
        K = ref_asm.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = RefBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                              mesh.node_shape, vdim=3)
        rhs = ref_asm.assemble_vector_load(mesh, np.array([0.0, 1.0, -2.0]))
    return mesh, prepare_system(K, mesh, bc, rhs, vdim)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-30)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("vdim", [1, 3])
def test_plain_spmv_matches_pallas_interpret(vdim, resident):
    mesh, sysm = _system(vdim)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                  block=512, interpret=True, resident=resident)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        sysm.b_hat.shape).astype(np.float32)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    y = port.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, y_ref) <= 1e-5  # f32 sums in another order
    # and both against the f64 host apply
    y64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                           x.astype(np.float64), mesh.dim, vdim)
    assert _rel(y, y64) <= 1e-5
    assert port.launches == 0  # the CPU path launches no kernel


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("vdim", [1, 3])
def test_bf16_weights_match_pallas_interpret(vdim, resident):
    mesh, sysm = _system(vdim)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                  block=512, interpret=True, resident=resident
                  ).as_weight_dtype(jnp.bfloat16)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu"
                                  ).as_weight_dtype(torch.bfloat16)
    assert port.variant == f"v{vdim}_bf16"
    x = np.random.default_rng(1).standard_normal(
        sysm.b_hat.shape).astype(np.float32)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    y = port.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, y_ref) <= 1e-5  # same bf16 weights, f32 products


@pytest.mark.parametrize("vdim", [1, 3])
def test_packed_weights_carry_over_bit_equal(vdim):
    mesh, sysm = _system(vdim)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                  block=512, interpret=True)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu")
    conv = convert.flat_operator_from_packed(np.asarray(ref.Wf), sysm.offsets,
                                             mesh.node_shape, vdim, "cpu")
    assert conv.deltas == port.deltas == tuple(ref.deltas)
    assert torch.equal(conv.W, port.W)
    ref_bf = np.asarray(ref.as_weight_dtype(jnp.bfloat16).Wf)
    ref_bits = ref_bf.view(np.uint16).reshape(ref_bf.shape[0], -1)[:, :port.N]
    port_bits = port.as_weight_dtype(torch.bfloat16).W.view(torch.int16)
    assert np.array_equal(port_bits.numpy().view(np.uint16), ref_bits)


@pytest.mark.parametrize("vdim", [1, 3])
def test_flat_layout_matches_reference_order(vdim):
    mesh, sysm = _system(vdim)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                  block=512, interpret=True)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu")
    x = np.random.default_rng(2).standard_normal(
        sysm.b_hat.shape).astype(np.float32)
    xf_ref = np.asarray(ref.to_flat(jnp.asarray(x))).reshape(vdim, -1)
    xf = port.to_flat(torch.from_numpy(x))
    assert np.array_equal(xf.numpy(), xf_ref[:, :port.N])
    assert np.array_equal(port.from_flat(xf).numpy(), x)


def test_plain_spmv_2d_and_grid_stencil_apply():
    mesh = ref_rect(12, 9, (0, 0), (1.0, 1.0))
    K = ref_asm.assemble_scalar_stencil(mesh, "mass")
    bc = RefBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    sysm = prepare_system(K, mesh, bc, np.zeros(mesh.node_shape), 1)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=1,
                  block=256, interpret=True)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=1, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        mesh.node_shape).astype(np.float32)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    assert _rel(port.apply(torch.from_numpy(x)).numpy(), y_ref) <= 1e-5
    # the per-offset (non-kernel) grid path of _stencil_apply, in f64
    w64 = tuple(torch.from_numpy(np.asarray(W)) for W in sysm.weights)
    y64 = port_ls._stencil_apply(sysm.offsets, w64,
                                 torch.from_numpy(x.astype(np.float64)), 2, 1)
    y_np = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                            x.astype(np.float64), 2, 1)
    assert _rel(y64.numpy(), y_np) <= 1e-12


def test_block_grid_stencil_apply_matches_numpy():
    mesh, sysm = _system(3)
    x = np.random.default_rng(4).standard_normal(sysm.b_hat.shape)
    w64 = tuple(torch.from_numpy(np.asarray(W)) for W in sysm.weights)
    y = port_ls._stencil_apply(sysm.offsets, w64, torch.from_numpy(x), 3, 3)
    y_np = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)), x, 3, 3)
    assert _rel(y.numpy(), y_np) <= 1e-12


def test_non_cpu_tensor_never_falls_back_to_plain():
    mesh, sysm = _system(1)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=1, device="cpu")
    x = torch.zeros((1, port.N), device="meta")
    with pytest.raises(ValueError):
        port.apply_flat(x)
    assert port.launches == 0 and not sk.KERNEL_LAUNCHES


def test_kernel_routing_threshold():
    assert sk.KERNEL_MIN_DOF == 0
    assert sk.kernel_wins(1) and sk.kernel_wins(2_040_675)
