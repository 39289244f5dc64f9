"""The port's disk-cache layer on the CPU: the npz round trip and eviction,
``prepare_system``'s disk entry (read alike by both packages), the dense
float32 hierarchy rebuilt from disk bit-equal to a fresh build down to the
solve, the entries that must be misses, and the static flat-operator cache.

Every case writes under its own ``PDE_TPU_CACHE_DIR``."""

import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh as ref_box_mesh
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import linsolve as ref_linsolve
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu.utils import diskcache as ref_diskcache
from pde_solver_tpu_torch.config import SolverConfig
from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.ops import assembly, linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.linsolve import prepare_system
from pde_solver_tpu_torch.utils import diskcache, kept
from pde_solver_tpu_torch.utils.observability import get_logger

LAM, MU = 1.2115384615384616e11, 8.076923076923077e10  # E=210e9, ν=0.3
BEAM = (16, 6, 6)          # the reference's block case


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PDE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("PDE_TPU_DISK_CACHE", "1")
    monkeypatch.delenv("PDE_TPU_CS", raising=False)
    kept.clear_all()
    ref_linsolve._PREP_CACHE.clear()
    yield tmp_path
    kept.clear_all()
    ref_linsolve._PREP_CACHE.clear()


@pytest.fixture()
def log_lines():
    """The port logger's INFO messages while the test runs."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = get_logger()
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    yield lines
    logger.removeHandler(handler)
    logger.setLevel(level)


def _heat(cells=(8, 8, 8), package="port"):
    """Scaled Poisson system on a unit box, all-boundary Dirichlet, and its
    coarse-level builder."""
    pkg_mesh, pkg_asm, BC = ((box_mesh, assembly, DirichletBC)
                             if package == "port"
                             else (ref_box_mesh, ref_asm, RefBC))
    mesh = pkg_mesh(*cells, (0, 0, 0), (1.0, 1.0, 1.0))

    def builder(mc):
        return (pkg_asm.assemble_scalar_stencil(mc, "stiffness"),
                BC.from_masks([(mc.boundary_mask(), 0.0)], mc.node_shape))

    K, bc = builder(mesh)
    return mesh, K, bc, pkg_asm.assemble_load(mesh), 1, builder


def _beam(cells=BEAM, package="port"):
    """Gravity-loaded cantilever clamped at x = 0 (vdim 3)."""
    pkg_mesh, pkg_asm, BC = ((box_mesh, assembly, DirichletBC)
                             if package == "port"
                             else (ref_box_mesh, ref_asm, RefBC))
    mesh = pkg_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))

    def builder(mc):
        return (pkg_asm.assemble_elasticity_stencil(mc, LAM, MU),
                BC.from_masks([(mc.face_mask(0, 0), 0.0)], mc.node_shape,
                              vdim=3))

    K, bc = builder(mesh)
    b = pkg_asm.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    return mesh, K, bc, b, 3, builder


SYSTEMS = {"heat": _heat, "beam": _beam}


def _eq(a, b):
    """Same dtype, shape and bits (tensors or arrays)."""
    a = a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))
    b = b.cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.array(b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _ops(w):
    """The tensors an operator applies with: packed weights, or the tuple."""
    if w is None:
        return ()
    return (w.W,) if hasattr(w, "W") else tuple(w)


# ----------------------------------------------------------------------
# utils.diskcache
# ----------------------------------------------------------------------

def test_roundtrip_arrays_and_meta():
    key = ("some", "key", 3)
    arrays = {"a": np.arange(12.0).reshape(3, 4),
              "b": np.ones(5, dtype=np.float32)}
    diskcache.store("t", key, arrays, meta={"x": 1, "names": ["p", "q"]})
    ent = diskcache.load("t", key)
    assert ent is not None
    np.testing.assert_array_equal(ent["a"], arrays["a"])
    assert ent["b"].dtype == np.float32
    assert ent["meta"] == {"x": 1, "names": ["p", "q"]}
    assert diskcache.load("t", ("other",)) is None


def test_eviction_bounds_total_bytes(monkeypatch):
    monkeypatch.setenv("PDE_TPU_CACHE_MAX_GB", str(1.0 / 1024))  # 1 MiB
    for i in range(6):
        diskcache.store("e", i, {"a": np.zeros(400_00, dtype=np.float64)})
        time.sleep(0.01)  # distinct mtimes for LRU ordering
    present = [i for i in range(6) if diskcache.load("e", i) is not None]
    assert present, "eviction removed everything"
    assert 0 not in present, "oldest entry should be evicted first"


def test_default_directory_is_ignored_by_git(monkeypatch):
    import os

    monkeypatch.delenv("PDE_TPU_CACHE_DIR")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert diskcache.cache_dir() == os.path.join(repo, "build", "cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()


# ----------------------------------------------------------------------
# prepare_system's disk entry
# ----------------------------------------------------------------------

@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_prepare_system_disk_persistence(system, monkeypatch, log_lines):
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 1)
    mesh, K, bc, b, vdim, _ = SYSTEMS[system]()
    s1 = prepare_system(K, mesh, bc, b, vdim)
    assert s1.ckey is not None
    assert diskcache.load("prep", s1.ckey) is not None
    # a fresh process: the memory cache emptied, the disk kept
    linsolve._PREP_CACHE.clear()
    s2 = prepare_system(K, mesh, bc, b, vdim)
    assert any(line.startswith("prep disk-cache hit") for line in log_lines)
    assert s2.ckey == s1.ckey
    for W1, W2 in zip(s1.weights, s2.weights):
        assert _eq(W1, W2)
    assert _eq(s1.b_hat, s2.b_hat)
    for a1, a2 in ((s1.s, s2.s), (s1.Ct, s2.Ct), (s1.CinvT, s2.CinvT)):
        assert (a1 is None and a2 is None) or _eq(a1, a2)
    # arrays from disk are frozen before they are shared
    with pytest.raises(ValueError):
        np.asarray(s2.weights[0])[0] = 99.0
    scale = s2.s if vdim == 1 else s2.Ct
    assert not scale.flags.writeable


def test_prepare_system_below_the_size_gate_stores_nothing(cache_dir):
    mesh, K, bc, b, vdim, _ = _heat()
    assert prepare_system(K, mesh, bc, b, vdim).ckey is None
    assert not list(cache_dir.iterdir())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_prep_entry_is_read_alike_by_both_packages(writer, monkeypatch):
    """A prep entry written by either package is a disk hit for the other,
    with bit-equal scaled weights and b̂."""
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 1)
    monkeypatch.setattr(ref_linsolve, "_PREP_CACHE_MIN_DOF", 1)
    hits = {"jax": [], "port": []}
    for name, mod in (("jax", ref_diskcache), ("port", diskcache)):
        def spy(kind, key, _load=mod.load, _hits=hits[name]):
            ent = _load(kind, key)
            _hits.append((kind, ent is not None))
            return ent
        monkeypatch.setattr(mod, "load", spy)
    ref = _beam(package="jax")
    port = _beam(package="port")

    def prep_ref():
        mesh, K, bc, b, vdim, _ = ref
        return ref_linsolve.prepare_system(K, mesh, bc, b, vdim)

    def prep_port():
        mesh, K, bc, b, vdim, _ = port
        return prepare_system(K, mesh, bc, b, vdim)

    first, second = ((prep_ref, prep_port) if writer == "jax"
                     else (prep_port, prep_ref))
    s1 = first()
    reader = "port" if writer == "jax" else "jax"
    assert hits[writer] == [("prep", False)]
    s2 = second()
    assert hits[reader] == [("prep", True)], "the other package's entry " \
        "was not a hit"
    assert s1.ckey == s2.ckey
    for W1, W2 in zip(s1.weights, s2.weights):
        assert _eq(W1, W2)
    assert _eq(s1.b_hat, s2.b_hat)
    assert _eq(s1.Ct, s2.Ct) and _eq(s1.CinvT, s2.CinvT)


# ----------------------------------------------------------------------
# the dense float32 hierarchy
# ----------------------------------------------------------------------

def _hierarchy_case(system, route, monkeypatch):
    """(mesh, sysm, builder, vdim) with ``route``: "kernel" puts every
    level on the flat operator (plain version on the CPU) with its bf16
    smoother copy, "plain" keeps plain float32 tensors."""
    monkeypatch.setattr(sk, "KERNEL_MIN_DOF", 0 if route == "kernel"
                        else 10 ** 9)
    mesh, K, bc, b, vdim, builder = SYSTEMS[system]()
    return mesh, prepare_system(K, mesh, bc, b, vdim), builder, vdim


def _assert_levels_equal(h1, h2):
    assert len(h1.levels) == len(h2.levels)
    assert (h1.grid_dim, h1.vdim, h1.pre_smooth, h1.post_smooth,
            h1.coarse_iters) == (h2.grid_dim, h2.vdim, h2.pre_smooth,
                                 h2.post_smooth, h2.coarse_iters)
    for l1, l2 in zip(h1.levels, h2.levels):
        assert l1.offsets == l2.offsets
        assert l1.omega == l2.omega            # stored, not re-estimated
        assert type(l1.weights) is type(l2.weights)
        for a1, a2 in zip(_ops(l1.weights), _ops(l2.weights)):
            assert _eq(a1, a2)
        assert (l1.w_lo is None) == (l2.w_lo is None)
        for a1, a2 in zip(_ops(l1.w_lo), _ops(l2.w_lo)):
            assert _eq(a1, a2)
        assert _eq(l1.free, l2.free)
        for a1, a2 in ((l1.s, l2.s), (l1.C, l2.C), (l1.Cinv, l2.Cinv)):
            assert (a1 is None and a2 is None) or _eq(a1, a2)
        # the host float64 weights round-trip the (hi, lo) pair: 2⁻⁴⁸ grade
        for w1, w2 in zip(l1.host_weights, l2.host_weights):
            np.testing.assert_allclose(w2, w1, rtol=0,
                                       atol=1e-13 * np.abs(w1).max())
        # and the pairs are bit-equal
        for p1, p2 in zip(l1.host_pairs, l2.host_pairs):
            for a1, a2 in zip(p1, p2):
                assert _eq(a1, a2)
    assert _eq(h1.levels[-1].Ainv, h2.levels[-1].Ainv)
    assert _eq(h1.levels[-1].host_Ainv, h2.levels[-1].host_Ainv)


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_hierarchy_disk_rebuild_is_bit_equal_to_fresh(system, route,
                                                       monkeypatch,
                                                       log_lines):
    mesh, sysm, builder, vdim = _hierarchy_case(system, route, monkeypatch)
    key = ("test-hier-key", system)
    fresh = mg.build_hierarchy(mesh, sysm, builder, vdim=vdim, device="cpu")
    h1 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim,
                                   device="cpu", cache_key=key)
    assert any(line.startswith("hierarchy disk-cache store")
               for line in log_lines)
    ent = diskcache.load("mgh", (key, vdim))
    assert ent["meta"]["cs"] == [False] * len(h1.levels)
    h2 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim,
                                   device="cpu", cache_key=key)
    assert any(line.startswith("hierarchy disk-cache hit")
               for line in log_lines)
    # the stored build carries its pairs: the same numbers as a plain build
    for lv in fresh.levels:
        assert lv.host_pairs is None
    _assert_levels_equal(fresh._replace(levels=tuple(
        lv._replace(host_pairs=p.host_pairs)
        for lv, p in zip(fresh.levels, h1.levels))), h1)
    _assert_levels_equal(h1, h2)
    # the ladder from the rebuilt hierarchy is bit-equal to a fresh split
    lads = [mg.build_df_ladder(h, sysm, sysm.b_hat) for h in (fresh, h2)]
    for W1, W2 in zip(lads[0].Whi + lads[0].Wlo, lads[1].Whi + lads[1].Wlo):
        for a1, a2 in zip(W1, W2):
            assert _eq(a1, a2)
    for a1, a2 in ((lads[0].bhi0, lads[1].bhi0), (lads[0].blo0, lads[1].blo0)):
        assert _eq(a1, a2)
    # and both solve to the same bits in the same iterations
    b32 = sysm.b_hat.astype(np.float32)
    x1, k1, r1 = mg.solve_mg(fresh, b32, None, 1e-6, 100)
    x2, k2, r2 = mg.solve_mg(h2, b32, None, 1e-6, 100)
    assert k1 == k2 and r1 == r2 and _eq(x1, x2)
    out1 = mg.solve_fcycle_df2(fresh, lads[0], 1e-9)
    out2 = mg.solve_fcycle_df2(h2, lads[1], 1e-9)
    assert out1[2] == out2[2] and out1[3] == out2[3]
    assert _eq(out1[0], out2[0]) and _eq(out1[1], out2[1])


def test_hierarchy_cache_ignored_for_f64(cache_dir):
    mesh, K, bc, b, vdim, builder = _heat()
    sysm = prepare_system(K, mesh, bc, b, vdim)
    key = ("f64-key",)
    h = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=1, device="cpu",
                                  dtype=torch.float64, cache_key=key)
    assert h.levels[0].free.dtype == torch.float64
    # nothing stored: the f64 path must not round-trip through f32 pairs
    assert diskcache.load("mgh", (key, 1)) is None
    assert not list(cache_dir.iterdir())


def test_reference_entry_with_cs_levels_is_a_miss(monkeypatch, log_lines):
    """The JAX package stores the beam's translation-invariant levels in
    constant-interior form; the port does not read that form: a miss, then
    a fresh build, which replaces the entry with a dense one."""
    ref_mesh, K, bc, b, vdim, ref_builder = _beam(package="jax")
    ref_sysm = ref_linsolve.prepare_system(K, ref_mesh, bc, b, vdim)
    key = ("cs-block-key",)
    ref_mg.build_hierarchy_cached(ref_mesh, ref_sysm, ref_builder, vdim=3,
                                  dtype=jnp.float32, cache_key=key)
    assert any(diskcache.load("mgh", (key, 3))["meta"]["cs"])
    assert mg.load_hierarchy_from_disk(key, 3, "cpu") is None
    assert any("constant-interior" in line for line in log_lines)
    mesh, sysm, builder, _ = _hierarchy_case("beam", "kernel", monkeypatch)
    builds = []
    orig = mg.build_hierarchy
    monkeypatch.setattr(mg, "build_hierarchy",
                        lambda *a, **kw: builds.append(1) or orig(*a, **kw))
    h = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=3, device="cpu",
                                  cache_key=key)
    assert builds == [1] and h is not None
    assert not any(diskcache.load("mgh", (key, 3))["meta"]["cs"])


@pytest.mark.parametrize("fault", ["garbage bytes", "missing level"])
def test_corrupt_hierarchy_entry_is_a_miss(fault, monkeypatch):
    mesh, sysm, builder, vdim = _hierarchy_case("heat", "kernel", monkeypatch)
    key = ("corrupt-key",)
    h1 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim,
                                   device="cpu", cache_key=key)
    path = diskcache._path("mgh", (key, vdim))
    if fault == "garbage bytes":
        with open(path, "wb") as f:
            f.write(b"not an npz entry")
    else:
        ent = diskcache.load("mgh", (key, vdim))
        meta = ent.pop("meta")
        n = meta["n_levels"] - 1
        for name in [k for k in ent if k.endswith(str(n))]:
            del ent[name]
        diskcache.store("mgh", (key, vdim), ent, meta)
    assert mg.load_hierarchy_from_disk(key, vdim, "cpu") is None
    h2 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim,
                                   device="cpu", cache_key=key)
    _assert_levels_equal(h1, h2)


@pytest.mark.parametrize("cs", ["1", "hybrid"])
def test_cs_route_neither_loads_nor_stores(cs, monkeypatch):
    from pde_solver_tpu_torch.ops import cs_kernels as ck

    mesh, sysm, builder, vdim = _hierarchy_case("heat", "kernel", monkeypatch)
    key = ("cs-route-key",)
    mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim, device="cpu",
                              cache_key=key)
    assert diskcache.load("mgh", (key, vdim)) is not None
    monkeypatch.setenv("PDE_TPU_CS", cs)
    monkeypatch.setattr(ck, "CS_MIN_DOF", 100)
    loads = []
    orig_load = diskcache.load
    monkeypatch.setattr(diskcache, "load",
                        lambda kind, k: loads.append(kind) or orig_load(kind,
                                                                        k))
    h = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=vdim,
                                  device="cpu", cache_key=key + ("cs",))
    assert "mgh" not in loads
    assert isinstance(h.levels[0].weights, ck.CSFlatStencilOperator)
    assert orig_load("mgh", (key + ("cs",), vdim)) is None


def test_solve_stencil_system_second_process_hits_both_entries(monkeypatch,
                                                               log_lines):
    """The mixed branch end to end: a cold solve stores the prep and
    hierarchy entries; a fresh process (memory caches emptied) loads both
    and solves to the same bits in the same iterations."""
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 1)
    mesh, K, bc, b, vdim, builder = _beam()
    cfg = SolverConfig(device="cpu", precision="mixed",
                       host_direct_threshold=0, mg_threshold=100)

    def solve():
        return linsolve.solve_stencil_system(K, mesh, bc, b, vdim=vdim,
                                             config=cfg,
                                             mg_level_builder=builder)

    x1, st1 = solve()
    assert any(line.startswith("prep disk-cache store") for line in log_lines)
    assert any(line.startswith("hierarchy disk-cache store")
               for line in log_lines)
    del log_lines[:]
    for cache in (linsolve._PREP_CACHE, linsolve._MG_CACHE):
        cache.clear()
    x2, st2 = solve()
    assert any(line.startswith("prep disk-cache hit") for line in log_lines)
    assert any(line.startswith("hierarchy disk-cache hit")
               for line in log_lines)
    assert int(st1.iterations) == int(st2.iterations)
    assert float(st1.relative_residual) == float(st2.relative_residual)
    assert _eq(x1, x2)


# ----------------------------------------------------------------------
# the static flat-operator cache
# ----------------------------------------------------------------------

def test_flat_op_cache_hands_back_the_same_operator(monkeypatch):
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 1)
    mesh, K, bc, b, vdim, _ = _heat()
    sysm = prepare_system(K, mesh, bc, b, vdim)
    op1 = linsolve._static_flat_op(sysm, mesh, vdim, "cpu")
    op2 = linsolve._static_flat_op(sysm, mesh, vdim, "cpu")
    assert op1 is op2 and len(linsolve._FLAT_OP_CACHE) == 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, op1.N)).astype(np.float32))
    assert _eq(op1.apply_flat(x), sk.FlatStencilOperator(
        sysm.offsets, sysm.weights, mesh.node_shape, vdim=vdim,
        device="cpu").apply_flat(x))
    # another routing, another entry; the LRU keeps two
    monkeypatch.setenv("PDE_TPU_CS", "1")
    op3 = linsolve._static_flat_op(sysm, mesh, vdim, "cpu")
    assert op3 is not op1 and len(linsolve._FLAT_OP_CACHE) == 2
    # a system without a content key is never cached
    monkeypatch.setenv("PDE_TPU_CS", "0")
    plain = sysm._replace(ckey=None)
    assert linsolve._static_flat_op(plain, mesh, vdim, "cpu") is not \
        linsolve._static_flat_op(plain, mesh, vdim, "cpu")
    assert len(linsolve._FLAT_OP_CACHE) == 2
