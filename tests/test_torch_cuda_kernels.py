"""CUDA kernel of the port against its plain PyTorch version, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu_torch.ops import assembly
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.ops.linsolve import (_cg_unit_diag, np_stencil_apply,
                                               prepare_system)
from pde_solver_tpu_torch.ops import stencil_kernels as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _system(vdim, cells=(10, 6, 6)):
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.5, 0.5)) if len(cells) == 3 \
        else rectangle_mesh(*cells, (0, 0), (1.0, 1.0))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(all_boundary(mesh), 2.0)],
                                    mesh.node_shape)
        rhs = assembly.assemble_load(mesh)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        rhs = assembly.assemble_vector_load(mesh, np.array([0.0, 1.0, -2.0]))
    return mesh, prepare_system(K, mesh, bc, rhs, vdim)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("cells", [(10, 6, 6), (12, 9), (33, 7, 5)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vdim", [1, 3])
def test_kernel_matches_plain(card, vdim, bf16, cells):
    if vdim == 3 and len(cells) == 2:
        pytest.skip("vdim=3 elasticity needs a 3-D mesh")
    mesh, sysm = _system(vdim, cells)
    dt = torch.bfloat16 if bf16 else torch.float32
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=vdim, device=card).as_weight_dtype(dt)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (vdim, op.N)).astype(np.float32)).to(card)
    before = sk.KERNEL_LAUNCHES.get(op.variant, 0)
    y = op.apply_flat(x)
    torch.cuda.synchronize()
    assert op.launches == 1
    assert sk.KERNEL_LAUNCHES[op.variant] == before + 1
    y_plain = sk.spmv_plain(op.W, x, op.deltas, vdim)
    assert _rel(y.cpu(), y_plain.cpu()) <= 1e-5  # FMA vs separate roundings
    if not bf16:  # f32 weights: also against the f64 host apply
        y64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                               op.from_flat(x).cpu().numpy().astype(np.float64),
                               mesh.dim, vdim)
        assert _rel(op.from_flat(y).cpu(), y64) <= 1e-5


def test_kernel_rejects_what_it_does_not_take(card):
    mesh, sysm = _system(3)
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=3, device=card)
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((3, op.N), dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        op.apply_flat(torch.zeros((op.N, 3), device=card).t())
    assert op.launches == 0


def test_flat_cg_through_kernel_matches_cpu(card):
    mesh, sysm = _system(1, (12, 12, 12))
    b = np.asarray(sysm.b_hat, np.float32)
    out = {}
    for dev in ("cpu", card):
        op = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                    mesh.node_shape, vdim=1, device=dev)
        bt = torch.from_numpy(b).to(dev)
        x, k, relres = _cg_unit_diag(sysm.offsets, op, bt,
                                     torch.zeros_like(bt), 1e-6, 500, 3, 1)
        out[str(dev)] = (x.cpu().numpy(), k, relres, op.launches)
    x_cpu, k_cpu, rr_cpu, n_cpu = out["cpu"]
    x_gpu, k_gpu, rr_gpu, n_gpu = out["cuda"]
    assert n_cpu == 0 and n_gpu >= k_gpu > 0
    assert rr_cpu <= 1e-6 and rr_gpu <= 1e-6
    assert abs(k_gpu - k_cpu) <= 2
    assert _rel(x_gpu, x_cpu) <= 1e-5
