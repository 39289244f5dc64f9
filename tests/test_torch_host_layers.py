"""The port's copied numpy host layers are bit-equal to the JAX package's:
assembly, loads, Dirichlet masks and the masked + scaled system."""

import numpy as np
import pytest

from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import bc as ref_bc
from pde_solver_tpu.ops import linsolve as ref_ls
from pde_solver_tpu_torch import mesh as port_mesh
from pde_solver_tpu_torch.ops import assembly as port_asm
from pde_solver_tpu_torch.ops import bc as port_bc
from pde_solver_tpu_torch.ops import linsolve as port_ls

MESHES = {
    "box10x6x6": lambda m: m.box_mesh(10, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5)),
    "rect12x9": lambda m: m.rectangle_mesh(12, 9, (0, 0), (1.0, 0.75)),
}


def _stencils_equal(a, b):
    assert sorted(a) == sorted(b)
    for off in a:
        assert np.array_equal(a[off], b[off]), off


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("kind", ["stiffness", "mass"])
def test_scalar_stencil_bit_equal(name, kind):
    ref = ref_asm.assemble_scalar_stencil(MESHES[name](ref_mesh), kind)
    port = port_asm.assemble_scalar_stencil(MESHES[name](port_mesh), kind)
    _stencils_equal(ref, port)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_elasticity_stencil_and_load_bit_equal(name):
    mr, mp = MESHES[name](ref_mesh), MESHES[name](port_mesh)
    d = mr.dim
    _stencils_equal(ref_asm.assemble_elasticity_stencil(mr, 1.21e11, 8.08e10),
                    port_asm.assemble_elasticity_stencil(mp, 1.21e11, 8.08e10))
    f = np.array([0.3, -1.0, -9.81 * 7800][:d])
    assert np.array_equal(ref_asm.assemble_vector_load(mr, f),
                          port_asm.assemble_vector_load(mp, f))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("vdim", [1, 0])  # 0 → vdim = mesh dimension
def test_bc_and_prepare_system_bit_equal(name, vdim):
    mr, mp = MESHES[name](ref_mesh), MESHES[name](port_mesh)
    v = vdim or mr.dim
    rng = np.random.default_rng(3)
    if v == 1:
        Kr = ref_asm.assemble_scalar_stencil(mr, "stiffness")
        Kp = port_asm.assemble_scalar_stencil(mp, "stiffness")
        pairs_r = [(ref_bc.all_boundary(mr), 2.0), (mr.face_mask(0, 0), -1.0)]
        pairs_p = [(port_bc.all_boundary(mp), 2.0), (mp.face_mask(0, 0), -1.0)]
        rhs = rng.standard_normal(mr.node_shape)
    else:
        Kr = ref_asm.assemble_elasticity_stencil(mr, 1.21e11, 8.08e10)
        Kp = port_asm.assemble_elasticity_stencil(mp, 1.21e11, 8.08e10)
        pairs_r = [(mr.face_mask(0, 0), 0.0), (mr.face_mask(0, 1), 1e-3)]
        pairs_p = [(mp.face_mask(0, 0), 0.0), (mp.face_mask(0, 1), 1e-3)]
        rhs = rng.standard_normal(mr.node_shape + (v,))
    bcr = ref_bc.DirichletBC.from_masks(pairs_r, mr.node_shape, vdim=v)
    bcp = port_bc.DirichletBC.from_masks(pairs_p, mp.node_shape, vdim=v)
    assert np.array_equal(bcr.free_mask, bcp.free_mask)
    assert np.array_equal(bcr.values, bcp.values)
    assert bcr.free_mask.dtype == bcp.free_mask.dtype

    sr = ref_ls.prepare_system(Kr, mr, bcr, rhs, v)
    sp = port_ls.prepare_system(Kp, mp, bcp, rhs, v)
    assert sr.offsets == sp.offsets and sr.scale_kind == sp.scale_kind
    for Wr, Wp in zip(sr.weights, sp.weights):
        assert np.array_equal(Wr, Wp)
    for field in ("b_hat", "gvals", "free", "s", "Ct", "CinvT"):
        a, b = getattr(sr, field), getattr(sp, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, b), field
