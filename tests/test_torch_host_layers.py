"""The port's copied numpy host layers are bit-equal to the JAX package's:
assembly, loads, Dirichlet masks and the masked + scaled system.  The
port's class-grid assembly of constant-coefficient stencils is bit-equal
to its full-grid slice-adds, in the same key order, and gives the same
content key; that key, taken from the class grids once their full arrays
have been hashed, is byte for byte the full hash, and only an intact
expansion is keyed so."""

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
from pde_solver_tpu_torch.ops import surface, timestepping
from pde_solver_tpu_torch.utils import kept
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


# ---- the prep key from the class grid ---------------------------------------

@pytest.fixture()
def states(monkeypatch):
    """An empty memo of stencil hash states for the test."""
    memo = kept.Kept(port_ls._STENCIL_STATES.size)
    monkeypatch.setattr(port_ls, "_STENCIL_STATES", memo)
    return memo


def _vdim(form, mesh):
    return mesh.dim if form == "elasticity" else 1


def _free(mesh, vdim, seed=2):
    shape = mesh.node_shape + ((vdim,) if vdim > 1 else ())
    rng = np.random.default_rng(seed)
    return (rng.random(shape) > 0.2).astype(np.float64)


def _keyed(stencil, free, mesh, vdim):
    """(the prep key, its request's hashed bytes and memo reuses)."""
    stats = {}
    with obs.request(stats):
        key = port_ls._prep_cache_key(stencil, free, mesh.node_shape, vdim)
    return key, stats["hashed_bytes"], stats["stencil_digest_reuses"]


def _full_key(stencil, free, mesh, vdim):
    """The prep key hashed from the full arrays: the port's
    ``kept.digest`` and the JAX package's key, which must agree."""
    plain = {off: np.array(W) for off, W in stencil.items()}
    digest = kept.digest([plain[off] for off in sorted(plain)] + [free])
    ref = ref_ls._prep_cache_key(plain, free, mesh.node_shape, vdim)
    assert ref[3] == digest
    return ref


def _grid_bytes(stencil):
    return sum(g.nbytes for g in stencil.source()[3])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(CLASS_MESHES))
def test_prep_key_from_the_class_grid_is_the_full_hash(states, name, form):
    mesh = _class_mesh(name)
    vdim = _vdim(form, mesh)
    free = _free(mesh, vdim)
    cold = FORMS[form](mesh)
    full = _full_key(cold, free, mesh, vdim)
    stencil_bytes = sum(W.nbytes for W in cold.values())
    # a miss: the class grids, then the full arrays and the mask
    assert _keyed(cold, free, mesh, vdim) == (
        full, _grid_bytes(cold) + stencil_bytes + free.nbytes, 0)
    # a fresh assembly of the same form: the class grids and the mask
    warm = FORMS[form](mesh)
    assert _keyed(warm, free, mesh, vdim) == (
        full, _grid_bytes(warm) + free.nbytes, 1)
    # another free mask: another key, from the same kept state
    other = _free(mesh, vdim, seed=7)
    other[(0,) * other.ndim] = 1.0 - other[(0,) * other.ndim]
    key, _, reuses = _keyed(warm, other, mesh, vdim)
    assert key == _full_key(warm, other, mesh, vdim) and reuses == 1
    assert key != full
    assert len(states) == 1


def _altered(case, mesh, K, M):
    if case == "slices":
        return None                    # built below, by slice-adds
    if case == "combine":
        return timestepping._combine(K, M, 0.01, 1.0)
    if case == "add_stencil":
        return surface.add_stencil(K, M)
    if case == "copied":
        return dict(K)
    if case == "replaced":
        out = K
        off = sorted(out)[0]
        out[off] = np.array(out[off])  # the same values, another array
        return out
    if case == "rewritten":
        out = K
        W = out[sorted(out)[0]]
        W.setflags(write=True)
        W *= 2.0
        return out
    raise ValueError(case)


@pytest.mark.parametrize("case", ["slices", "combine", "add_stencil",
                                  "copied", "replaced", "rewritten"])
def test_other_stencils_hash_their_full_arrays(monkeypatch, states, case):
    mesh = _class_mesh("box9x4x5")
    free = _free(mesh, 1)
    build = FORMS["stiffness"]
    _keyed(build(mesh), free, mesh, 1)          # the memo holds the form
    if case == "slices":
        altered, _ = _by_slices(monkeypatch, build, mesh)
    else:
        altered = _altered(case, mesh, build(mesh), FORMS["mass"](mesh))
    full = _full_key(altered, free, mesh, 1)
    stencil_bytes = sum(np.asarray(W).nbytes for W in altered.values())
    assert _keyed(altered, free, mesh, 1) == (
        full, stencil_bytes + free.nbytes, 0)
    assert len(states) == 1


@pytest.mark.parametrize("form", sorted(FORMS))
def test_expanded_arrays_are_read_only(form):
    stencil = FORMS[form](_class_mesh("box2x1x3"))
    for W in stencil.values():
        with pytest.raises(ValueError):
            W[(0,) * W.ndim] = 1.0
        with pytest.raises(ValueError):
            W += 1.0
    for grid in stencil.source()[3]:
        assert not grid.flags.writeable


def test_stencil_memo_stays_within_its_bound(states):
    meshes = [port_mesh.StructuredMesh((n,), (0.0,), (1.0 + 0.1 * n,))
              for n in range(3, 3 + states.size + 4)]
    for mesh in meshes:
        _keyed(FORMS["stiffness"](mesh), np.ones(mesh.node_shape), mesh, 1)
        assert len(states) <= states.size
    assert len(states) == states.size
    newest, oldest = meshes[-1], meshes[0]
    assert _keyed(FORMS["stiffness"](newest), np.ones(newest.node_shape),
                  newest, 1)[2] == 1
    assert _keyed(FORMS["stiffness"](oldest), np.ones(oldest.node_shape),
                  oldest, 1)[2] == 0
    assert len(states) == states.size


@pytest.mark.parametrize("name", ["line7", "rect9x4", "box9x4x5"])
def test_forms_of_one_mesh_keep_their_own_states(states, name):
    """Stiffness and mass share the cell shape and offsets; their class
    grids tell them apart."""
    mesh = _class_mesh(name)
    free = _free(mesh, 1)
    for form in ("stiffness", "mass", "mass_q2"):
        stencil = FORMS[form](mesh)
        key, _, reuses = _keyed(stencil, free, mesh, 1)
        assert key == _full_key(stencil, free, mesh, 1) and reuses == 0
    assert len(states) == 3
