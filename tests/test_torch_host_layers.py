"""The port's copied numpy host layers are bit-equal to the JAX package's:
assembly, loads, Dirichlet masks and the masked + scaled system.  The
port's class-grid assembly of constant-coefficient stencils is bit-equal
to its full-grid slice-adds, in the same key order, and gives the same
content key."""

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
from pde_solver_tpu_torch.utils import observability as obs

MESHES = {
    "box10x6x6": lambda m: m.box_mesh(10, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5)),
    "box40x16x16": lambda m: m.box_mesh(40, 16, 16, (0, 0, 0),
                                        (1.0, 0.2, 0.2)),
    "rect12x9": lambda m: m.rectangle_mesh(12, 9, (0, 0), (1.0, 0.75)),
}

# (n_cells, extent): axes of 1 and 2 cells, anisotropic spacing
CLASS_MESHES = {
    "line7": ((7,), (1.3,)),
    "line1": ((1,), (0.4,)),
    "line2": ((2,), (2.0,)),
    "rect1x2": ((1, 2), (1.0, 0.3)),
    "rect9x4": ((9, 4), (2.0, 0.25)),
    "box1x1x1": ((1, 1, 1), (1.0, 1.0, 1.0)),
    "box2x1x3": ((2, 1, 3), (1.0, 0.2, 0.7)),
    "box9x4x5": ((9, 4, 5), (1.0, 0.25, 0.3)),
}
FORMS = {
    "elasticity": lambda m: port_asm.assemble_elasticity_stencil(
        m, 1.21e11, 8.08e10),
    "stiffness": lambda m: port_asm.assemble_scalar_stencil(m, "stiffness"),
    "mass": lambda m: port_asm.assemble_scalar_stencil(m, "mass"),
    "mass_q2": lambda m: port_asm.assemble_scalar_stencil(
        m, "mass", quad_degree=2),
}


def _class_mesh(name):
    n, extent = CLASS_MESHES[name]
    return port_mesh.StructuredMesh(n, (0.0,) * len(n), extent)


def _counted(build, mesh):
    """(stencil, the request's two assembly counters)."""
    stats = {}
    with obs.request(stats):
        st = build(mesh)
    return st, (stats["stencils_by_class"], stats["stencils_by_slices"])


def _by_slices(monkeypatch, build, mesh):
    """``build`` with the class grid swapped for full-grid slice-adds."""
    with monkeypatch.context() as mp:
        mp.setattr(port_asm, "_Classes", port_asm._Slices)
        return _counted(build, mesh)


def _stencils_equal(a, b):
    assert list(a) == list(b)
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


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(CLASS_MESHES))
def test_class_grid_equals_slice_adds(monkeypatch, name, form):
    mesh = _class_mesh(name)
    classes, counts = _counted(FORMS[form], mesh)
    slices, slice_counts = _by_slices(monkeypatch, FORMS[form], mesh)
    assert counts == (1, 0) and slice_counts == (0, 1)
    assert list(classes) == list(slices)
    for off in slices:
        assert classes[off].flags.c_contiguous, off
        assert classes[off].dtype == slices[off].dtype, off
        assert np.array_equal(classes[off], slices[off]), off


def _radius(x):
    return x[..., 0] + 0.5


@pytest.mark.parametrize("case", ["weight_fn", "cell_coeff",
                                  "cell_coeff_per_subelem", "mass_weight_fn"])
def test_weighted_or_per_cell_forms_take_slice_adds(case):
    mesh = _class_mesh("box2x1x3")
    rng = np.random.default_rng(5)
    term = "mass" if case.startswith("mass") else "stiffness"
    kw = {}
    if case.endswith("weight_fn"):
        kw["weight_fn"] = _radius
    elif case == "cell_coeff":
        kw["cell_coeff"] = 1.0 + rng.random(mesh.cell_shape)
    else:
        kw["cell_coeff"] = 1.0 + rng.random((len(mesh.subelems),)
                                            + mesh.cell_shape)
    st, counts = _counted(
        lambda m: port_asm.assemble_scalar_stencil(m, term, **kw), mesh)
    assert counts == (0, 1)
    ref = ref_asm.assemble_scalar_stencil(
        ref_mesh.StructuredMesh(mesh.n_cells, mesh.origin, mesh.extent),
        term, **kw)
    _stencils_equal(ref, st)


@pytest.mark.parametrize("form", ["elasticity", "mass"])
def test_class_grid_keeps_the_prep_content_key(monkeypatch, form):
    mesh = _class_mesh("box9x4x5")
    vdim = mesh.dim if form == "elasticity" else 1
    shape = mesh.node_shape + ((vdim,) if vdim > 1 else ())
    free = (np.random.default_rng(2).random(shape) > 0.2).astype(np.float64)
    classes, _ = _counted(FORMS[form], mesh)
    slices, _ = _by_slices(monkeypatch, FORMS[form], mesh)
    key = port_ls._prep_cache_key(classes, free, mesh.node_shape, vdim)
    assert key == port_ls._prep_cache_key(slices, free, mesh.node_shape,
                                          vdim)
