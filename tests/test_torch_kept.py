"""The port's kept state (``utils.kept``): each cache a bounded LRU at its
size, entries that hold graphs released on eviction and on ``clear()``,
``clear_all()`` emptying every cache the solve paths fill, and the scan
key's fallback hash in the ``setup.hash`` span."""

import hashlib

import numpy as np
import pytest

from pde_solver_tpu_torch import api
from pde_solver_tpu_torch.config import config_overrides
from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.ops import (assembly, device_loop, linsolve,
                                      timestepping)
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.parallel import shard_mg
from pde_solver_tpu_torch.utils import kept
from pde_solver_tpu_torch.utils import observability as obs

# name → (the cache, its size, whether its entries hold graphs)
CACHES = {
    "prep": (lambda: linsolve._PREP_CACHE, 2, False),
    "stencil_states": (lambda: linsolve._STENCIL_STATES, 8, False),
    "flat_ops": (lambda: linsolve._FLAT_OP_CACHE, 2, True),
    "hierarchies": (lambda: linsolve._MG_CACHE, 2, True),
    "theta_scans": (lambda: timestepping._SCAN_CACHE["theta"], 2, True),
    "newmark_scans": (lambda: timestepping._SCAN_CACHE["newmark"], 2, True),
    "shard_solvers": (lambda: shard_mg._SOLVER_CACHE, 4, True),
}
RELEASING = sorted(name for name, (_, _, g) in CACHES.items() if g)


@pytest.fixture(autouse=True)
def _empty():
    kept.clear_all()
    yield
    kept.clear_all()


class _Owner:
    """A stand-in entry holding one program in its graph store, and a
    hierarchy (``h``, as a scan's entry has) that holds one too.  It is its
    own ``[i]``, where the caches of (hierarchy, ladder) and (hierarchy,
    solver) tuples look."""

    def __init__(self, with_h: bool = True):
        self.graphs = device_loop.GraphStore()
        self.graphs.put("program", object())
        self.h = _Owner(False) if with_h else None

    def __getitem__(self, i):
        return self


@pytest.mark.parametrize("name", sorted(CACHES))
def test_each_cache_is_an_lru_at_its_size(name):
    """A hit makes its entry the most recent; past the size the least
    recent entry goes."""
    get, size, _ = CACHES[name]
    cache = get()
    assert isinstance(cache, kept.Kept) and cache.size == size
    entries = {k: _Owner() for k in range(size + 1)}
    for k in range(size):
        cache.put(k, entries[k])
    assert len(cache) == size and list(cache.keys()) == list(range(size))
    assert cache.get(0) is entries[0]             # 1 is now the least recent
    cache.put(size, entries[size])
    assert len(cache) == size and 1 not in cache.keys()
    assert list(cache.keys()) == list(range(2, size)) + [0, size]
    assert cache.get(1) is None
    assert dict(cache.items())[0] is entries[0]


@pytest.mark.parametrize("name", RELEASING)
def test_eviction_and_clear_release_graphs(name):
    """The entry that leaves, evicted or cleared, has its graphs freed (and
    a scan's hierarchy its own); the entries that stay keep theirs."""
    get, size, _ = CACHES[name]
    cache = get()

    def released(owner):
        # a scan's entry releases its hierarchy too
        return len(owner.graphs) == 0 and (
            not name.endswith("_scans") or len(owner.h.graphs) == 0)

    first = _Owner()
    cache.put("first", first)
    stay = [_Owner() for _ in range(size)]
    for i, owner in enumerate(stay):
        cache.put(i, owner)
    assert released(first)
    assert not any(released(owner) for owner in stay)
    again = _Owner()
    cache.put(0, again)        # a key held: replaced, not released
    assert not released(stay[0])
    cache.clear()
    assert len(cache) == 0
    assert released(again) and all(released(o) for o in stay[1:])


def test_clear_all_empties_every_port_cache(monkeypatch, tmp_path):
    """A small static solve (675 unknowns, content-keyed) at "mixed" and
    at "f32", a θ-scan with MG and a 2-shard virtual solve fill the port's
    caches; ``kept.clear_all()`` leaves every one empty and the graphs of
    their entries freed."""
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 600)
    monkeypatch.setenv("PDE_TPU_DISK_CACHE", "0")
    for precision in ("mixed", "f32"):
        with config_overrides(device="cpu", precision=precision,
                              mg_threshold=100, host_direct_threshold=0):
            api.solve_elasticity_3D_static(
                Lx=1.0, Ly=0.25, Lz=0.25, nx=8, ny=4, nz=4, body_fz=-7.7e4,
                data_dir=str(tmp_path))
    mesh = box_mesh(8, 6, 6, (0, 0, 0), (1.0, 0.5, 0.5))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 1.0)],
                                mesh.node_shape)
    u0 = np.asarray(bc.apply_values(np.zeros(mesh.node_shape)))

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                assembly.assemble_scalar_stencil(mc, "mass"),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 1.0)],
                                       mc.node_shape))

    with config_overrides(device="cpu", precision="mixed",
                          transient_mg_threshold=100, mg_threshold=100):
        timestepping.run_transient(K, M, mesh, bc, assembly.assemble_load(
            mesh), u0, dt=0.01, num_steps=3, mg_level_builder=builder)
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "2")
    with config_overrides(device="cpu", precision="f64", shard_devices=2,
                          mg_threshold=100, host_direct_threshold=0):
        linsolve.solve_stencil_system(
            K, mesh, bc, np.zeros(mesh.node_shape),
            mg_level_builder=lambda mc: builder(mc)[::2])
    caches = {name: get() for name, (get, _, _) in CACHES.items()}
    filled = sorted(name for name, c in caches.items() if len(c))
    assert filled == ["flat_ops", "hierarchies", "prep", "shard_solvers",
                      "stencil_states", "theta_scans"]
    # the programs of the "mixed" hierarchy, the scan and its hierarchy,
    # the sharded solver and the flat operator (the sharded solve's own
    # hierarchy runs none)
    stores = [h.graphs for key, (h, _) in linsolve._MG_CACHE.items()
              if key[2] == "mixed"]
    for scan in timestepping._SCAN_CACHE["theta"].values():
        stores += [scan.graphs, scan.h.graphs]
    stores += [device_loop.store_of(s) for _, s in
               shard_mg._SOLVER_CACHE.values()]
    stores += [device_loop.store_of(op)
               for op in linsolve._FLAT_OP_CACHE.values()]
    assert len(stores) == 5 and all(len(store) for store in stores)
    kept.clear_all()
    assert all(len(c) == 0 for c in caches.values())
    assert not any(len(store) for store in stores)


def test_scan_key_fallback_is_a_timed_counted_hash():
    """A system with no content key (under the key gate) is named by the
    hash of its scaled weights, free mask and scales: one ``setup.hash``
    span, its bytes in ``hashed_bytes``, the digest the blake2b-128 of
    those arrays in that order."""
    mesh = box_mesh(6, 4, 4, (0, 0, 0), (1.0, 0.5, 0.5))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    sysm = linsolve.prepare_system(K, mesh, bc, np.zeros(mesh.node_shape), 1)
    assert sysm.ckey is None
    arrays = [np.ascontiguousarray(a) for a in
              list(sysm.weights) + [sysm.free, sysm.s]]
    want = hashlib.blake2b(digest_size=16)
    for a in arrays:
        want.update(a)
    stats = {}
    with obs.request(stats):
        key = timestepping._scan_key("theta", mesh, 1, "f32", sysm, "cpu",
                                     (0.01,))
    spans = [sp.name for sp in obs.last_request().spans]
    assert spans == ["setup.hash"]
    assert stats["hashed_bytes"] == sum(a.nbytes for a in arrays) > 0
    assert stats["hash_seconds"] > 0
    assert key[7] == want.hexdigest() and key[8:] == (0.01,)
