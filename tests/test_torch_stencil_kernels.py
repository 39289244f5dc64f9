"""Flat-stencil SpMV of the port against the JAX package's Pallas kernels.

On the CPU the port's ``FlatStencilOperator`` runs ``spmv_plain``; the JAX
operator runs its Pallas kernels in interpret mode, in both the resident and
the windowed form.  The CUDA kernel itself is checked against ``spmv_plain``
on the card by ``test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import (box_mesh as ref_box,
                                 interval_mesh as ref_interval,
                                 rectangle_mesh as ref_rect)
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops.bc import DirichletBC as RefBC, all_boundary
from pde_solver_tpu.ops.linsolve import np_stencil_apply, prepare_system
from pde_solver_tpu.ops.pallas_kernels import FlatStencilOperator as RefFlat
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.ops import linsolve as port_ls
from pde_solver_tpu_torch.ops import stencil_kernels as sk


def _system(vdim, mesh=None):
    """vdim 1: scalar stiffness on a box; 2: plane elasticity on a
    rectangle (7 offsets); 3: elasticity on a box (15 offsets)."""
    mesh = mesh or (ref_rect(12, 9, (0, 0), (1.0, 0.75)) if vdim == 2
                    else ref_box(10, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5)))
    if vdim == 1:
        K = ref_asm.assemble_scalar_stencil(mesh, "stiffness")
        bc = RefBC.from_masks([(all_boundary(mesh), 2.0)], mesh.node_shape)
        rhs = ref_asm.assemble_load(mesh)
    else:
        K = ref_asm.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = RefBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                              mesh.node_shape, vdim=vdim)
        rhs = ref_asm.assemble_vector_load(
            mesh, np.array([0.0, 1.0, -2.0][:vdim]))
    return mesh, prepare_system(K, mesh, bc, rhs, vdim)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-30)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("vdim", [1, 2, 3])
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
@pytest.mark.parametrize("vdim", [1, 2, 3])
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


@pytest.mark.parametrize("vdim", [1, 2, 3])
def test_packed_weights_carry_over_bit_equal(vdim):
    mesh, sysm = _system(vdim)
    ref = RefFlat(sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
                  block=512, interpret=True)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu")
    conv = convert.flat_operator_from_packed(np.asarray(ref.Wf), sysm.offsets,
                                             mesh.node_shape, vdim, "cpu")
    assert conv.deltas == port.deltas == tuple(ref.deltas)
    # planes padded to N_pad, a multiple of 128, with a tail past N
    assert port.N_pad % 128 == 0 and port.N < port.N_pad < port.N + 128
    assert tuple(port.W.shape) == (port.n_off * vdim * vdim, port.N_pad)
    assert torch.equal(conv.W, port.W)
    ref_planes = np.asarray(ref.Wf).reshape(ref.Wf.shape[0], -1)
    assert np.array_equal(port.W.numpy(), ref_planes[:, :port.N_pad])
    assert not ref_planes[:, port.N:].any()   # the zero tail, both packs
    ref_bf = np.asarray(ref.as_weight_dtype(jnp.bfloat16).Wf)
    ref_bits = ref_bf.view(np.uint16).reshape(ref_bf.shape[0], -1)
    port_bits = port.as_weight_dtype(torch.bfloat16).W.view(torch.int16)
    assert port_bits.shape[1] == port.N_pad
    assert np.array_equal(port_bits.numpy().view(np.uint16),
                          ref_bits[:, :port.N_pad])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim", [1, 2, 3])
def test_padded_planes_give_the_unpadded_result_bit_equal(vdim, bf16):
    """``spmv_plain`` on the padded pack equals it on the same planes cut
    to N (the layout before padding), bit for bit; ``from_packed`` takes
    the padded pack only."""
    mesh, sysm = _system(vdim)
    port = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                  vdim=vdim, device="cpu")
    if bf16:
        port = port.as_weight_dtype(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (vdim, port.N)).astype(np.float32))
    unpadded = port.W[:, :port.N].contiguous()
    y = sk.spmv_plain(port.W, x, port.deltas, vdim)
    assert torch.equal(y, sk.spmv_plain(unpadded, x, port.deltas, vdim))
    assert not port.W[:, port.N:].any()
    repacked = sk.FlatStencilOperator.from_packed(
        torch.nn.functional.pad(unpadded, (0, port.N_pad - port.N)),
        sysm.offsets, mesh.node_shape, vdim)
    assert torch.equal(repacked.W, port.W)
    assert torch.equal(repacked.apply_flat(x), y)
    for bad in (unpadded, port.W[:, 1:]):
        with pytest.raises(ValueError, match="N_pad"):
            sk.FlatStencilOperator.from_packed(bad, sysm.offsets,
                                               mesh.node_shape, vdim)


@pytest.mark.parametrize("vdim", [1, 2, 3])
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


def test_cuda_operator_refuses_unbuilt_vdim():
    """A vdim the CUDA kernel is not built for is refused when a CUDA
    operator is constructed (before any device work), never at launch; the
    CPU plain version takes any vdim."""
    assert sk.KERNEL_VDIMS == (1, 2, 3)
    offsets = ((-1,), (0,), (1,))
    weights = [np.ones((6, 4, 4))] * 3
    with pytest.raises(ValueError, match="vdim"):
        sk.FlatStencilOperator(offsets, weights, (6,), vdim=4, device="cuda")
    op = sk.FlatStencilOperator(offsets, weights, (6,), vdim=4, device="cpu")
    y = op.apply_flat(torch.ones((4, 6)))
    assert torch.equal(y[:, 2], torch.full((4,), 12.0))


def test_cuda_operator_refuses_unbuilt_offset_count():
    """An offset count the CUDA kernel is not built for, or offsets that do
    not form its row groups, are refused when a CUDA operator is
    constructed; the CPU plain version takes any."""
    assert sk.KERNEL_NOFFS == (3, 7, 15)
    five = ((-2,), (-1,), (0,), (1,), (2,))
    with pytest.raises(ValueError, match="offset counts"):
        sk.FlatStencilOperator(five, [np.ones(6)] * 5, (6,), device="cuda")
    with pytest.raises(ValueError, match="row group"):
        sk.FlatStencilOperator(((-2,), (0,), (2,)), [np.ones(6)] * 3, (6,),
                               device="cuda")
    op = sk.FlatStencilOperator(five, [np.ones(6)] * 5, (6,), device="cpu")
    assert torch.equal(op.apply_flat(torch.ones((1, 6)))[0],
                       torch.tensor([3.0, 4.0, 5.0, 5.0, 4.0, 3.0]))


@pytest.mark.parametrize("cells", [(8,), (1,), (5, 4), (5, 1), (1, 1),
                                   (4, 3, 2), (3, 1, 1), (1, 1, 1)])
def test_p1_stencils_form_the_kernels_row_groups(cells):
    """The sorted P1 stencil of every mesh, thin ones included (where runs
    of consecutive deltas merge across groups), has one of the built offset
    counts and the kernel's row groups."""
    mesh = (ref_box(*cells, (0, 0, 0), (1.0, 1.0, 1.0)) if len(cells) == 3
            else ref_rect(*cells, (0, 0), (1.0, 1.0)) if len(cells) == 2
            else ref_interval(cells[0], 0.0, 1.0))
    offsets = tuple(sorted(ref_asm.assemble_scalar_stencil(mesh, "mass")))
    op = sk.FlatStencilOperator.__new__(sk.FlatStencilOperator)
    op._init_meta(offsets, mesh.node_shape, 1)
    assert op.n_off == 2 ** (len(cells) + 1) - 1
    sk._check_kernel_shape(1, op.deltas, "cuda")
    groups = sk.row_groups(op.n_off)
    assert [f for f, _ in groups] == sorted(f for f, _ in groups)
    assert sum(size for _, size in groups) == op.n_off
    assert all(offsets[f + s][:-1] == offsets[f][:-1]
               for f, size in groups for s in range(size))


def test_kernel_routing_threshold():
    assert sk.KERNEL_MIN_DOF == 0
    assert sk.kernel_wins(1) and sk.kernel_wins(2_040_675)
