"""The port's solve loops captured as CUDA graphs, held against the same
loops run uncaptured, on the card.

Every test is marked ``cuda`` and skips without a card (a CUDA graph has no
CPU mode).  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_graphs.py
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.ops import (assembly, device_loop, linsolve,
                                      multigrid as mg)
from pde_solver_tpu_torch.ops import cs_kernels as ck
from pde_solver_tpu_torch.ops import stencil_kernels as sk
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.ops.timestepping import run_newmark, run_transient
from pde_solver_tpu_torch.config import config_overrides

pytestmark = pytest.mark.cuda

# a captured run launches the same kernels in the same order as the
# uncaptured one; the bound leaves room for a library call that picks
# another algorithm under capture (the card has shown a gap of 0)
GAP = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _cantilever(cells=(16, 8, 8)):
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))

    def builder(m):
        return (assembly.assemble_elasticity_stencil(m, 1.3, 0.7),
                DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)],
                                       m.node_shape, vdim=3))

    K, bc = builder(mesh)
    rhs = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -1.0]))
    return mesh, linsolve.prepare_system(K, mesh, bc, rhs, 3), builder


def _gap(a, b):
    a = np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.cpu() if torch.is_tensor(b) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _both(fn):
    """fn() captured, then uncaptured: (captured result, uncaptured)."""
    captured = fn()
    with device_loop._uncaptured():
        plain = fn()
    return captured, plain


def test_mg_pcg_captured_matches_uncaptured(card):
    mesh, sysm, builder = _cantilever()
    for dtype in (torch.float32, torch.float64):
        def run():
            h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device=card,
                                   dtype=dtype)
            b = torch.as_tensor(sysm.b_hat, dtype=dtype, device=card)
            out = mg.mg_pcg(h, b, torch.zeros_like(b), 1e-6, 200)
            return out, len(h.graphs)
        ((x, k, rr), n_graphs), ((x0, k0, rr0), n0) = _both(run)
        assert k == k0 > 0 and n_graphs == 1
        assert _gap(x, x0) <= GAP and abs(rr - rr0) <= GAP * rr0


def test_flat_cg_captured_matches_uncaptured(card):
    mesh, sysm, _ = _cantilever()

    def run():
        op = sk.FlatStencilOperator(sysm.offsets, sysm.weights,
                                    mesh.node_shape, vdim=3, device=card)
        b = torch.as_tensor(sysm.b_hat, dtype=torch.float32, device=card)
        out = linsolve._cg_unit_diag(sysm.offsets, op, b, torch.zeros_like(b),
                                     1e-6, 5000, 3, 3)
        return out, op.launches, len(device_loop.store_of(op))

    ((x, k, rr), n, stored), ((x0, k0, rr0), n0, stored0) = _both(run)
    assert k == k0 > 0 and stored == 1
    assert _gap(x, x0) <= GAP
    # both ran the same blocks: the probe's (warm-up's) two applies, the
    # prologue's one, then one a masked iteration, replays counted
    assert n == n0 == 3 + linsolve.CG_BLOCK * -(-k0 // linsolve.CG_BLOCK)


def test_df2_and_solve_mg_captured_match_uncaptured(card):
    mesh, sysm, builder = _cantilever()

    def mixed():
        h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device=card)
        lad = mg.build_df_ladder(h, sysm, sysm.b_hat)
        return mg.solve_fcycle_df2(h, lad, 1e-9)

    (hi, lo, it, rr), (hi0, lo0, it0, rr0) = _both(mixed)
    assert it == it0 > 0 and rr <= 1e-9
    assert _gap(hi.double() + lo.double(), hi0.double() + lo0.double()) <= GAP

    def f64():
        h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device=card,
                               dtype=torch.float64)
        return mg.solve_mg(h, sysm.b_hat, None, 1e-10, 200)

    (x, k, _), (x0, k0, _) = _both(f64)
    assert k == k0 > 0 and _gap(x, x0) <= GAP


def test_transient_scans_captured_match_uncaptured(card):
    mesh = box_mesh(40, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    u0 = np.full(mesh.node_shape, 20.0)

    def builder(m):
        return (assembly.assemble_scalar_stencil(m, "stiffness"),
                assembly.assemble_scalar_stencil(m, "mass"),
                DirichletBC.from_masks([(m.boundary_mask(), 0.0)],
                                       m.node_shape))

    for mg_builder in (builder, None):
        def run():
            with config_overrides(device="cuda", transient_mg_threshold=100,
                                  mg_threshold=100):
                return run_transient(K, M, mesh, bc, np.zeros(u0.shape), u0,
                                     0.01, 5, mg_level_builder=mg_builder)
        res, res0 = _both(run)
        assert res.total_cg_iterations == res0.total_cg_iterations > 0
        assert _gap(res.values, res0.values) <= GAP

        def newmark():
            with config_overrides(device="cuda", transient_mg_threshold=100,
                                  mg_threshold=100):
                return run_newmark(K, M, mesh, bc, np.zeros(u0.shape), u0,
                                   np.zeros(u0.shape), 0.01, 5,
                                   mg_level_builder=mg_builder)
        res, res0 = _both(newmark)
        assert res.total_cg_iterations == res0.total_cg_iterations > 0
        assert _gap(res.values, res0.values) <= GAP
        assert _gap(res.velocities, res0.velocities) <= GAP


def test_cs_kernel_captured_matches_uncaptured(card):
    """The constant-interior kernel's ctypes launch inside a captured CG,
    its launches counted at each replay."""
    mesh = box_mesh(40, 12, 12, (0, 0, 0), (1.0, 0.25, 0.25))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    A = {o: M.get(o, 0.0) + 0.01 * K.get(o, 0.0) for o in set(K) | set(M)}
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    sysm = linsolve.prepare_system(A, mesh, bc, np.zeros(mesh.node_shape), 1)
    b = torch.as_tensor(np.random.default_rng(9).standard_normal(
        mesh.node_shape), dtype=torch.float32, device=card)

    def run():
        op = ck.CSFlatStencilOperator.try_build(
            sysm.offsets, sysm.weights, mesh.node_shape, vdim=1, device=card)
        out = linsolve._cg_unit_diag(sysm.offsets, op, b, torch.zeros_like(b),
                                     1e-6, 500, 3, 1, block=8)
        return out, op.launches

    ((x, k, _), n), ((x0, k0, _), n0) = _both(run)
    assert k == k0 > 0 and n == n0 == 3 + 8 * -(-k0 // 8)
    assert _gap(x, x0) <= GAP


def test_a_planted_capture_failure_raises(card, monkeypatch):
    """A host read inside the captured body fails the capture, and the
    solve raises: nothing drops back to the uncaptured loop."""
    mesh, sysm, _ = _cantilever()
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=3, device=card)
    b = torch.as_tensor(sysm.b_hat, dtype=torch.float32, device=card)
    orig = sk.FlatStencilOperator.apply_flat

    def syncing(self, x):
        torch.cuda.synchronize()
        return orig(self, x)

    monkeypatch.setattr(sk.FlatStencilOperator, "apply_flat", syncing)
    with pytest.raises(RuntimeError):
        linsolve._cg_unit_diag(sysm.offsets, op, b, torch.zeros_like(b),
                               1e-6, 500, 3, 3)
    assert sk._CAPTURED is None and len(device_loop.store_of(op)) == 0
    monkeypatch.undo()
    torch.cuda.synchronize()
    x, k, _ = linsolve._cg_unit_diag(sysm.offsets, op, b, torch.zeros_like(b),
                                     1e-6, 500, 3, 3)
    assert k > 0 and bool(torch.isfinite(x).all())


def test_replays_count_their_launches(card):
    mesh, sysm, _ = _cantilever()
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=3, device=card)
    b = torch.as_tensor(sysm.b_hat, dtype=torch.float32, device=card)
    linsolve._cg_unit_diag(sysm.offsets, op, b, torch.zeros_like(b), 1e-6,
                           5000, 3, 3)
    loop = device_loop.store_of(op).get(("cg", linsolve.CG_BLOCK,
                                         tuple(b.shape), b.dtype, True))
    ((variant, ref, n),) = loop.next.launches
    assert variant == "v3_f32" and ref() is op and n == linsolve.CG_BLOCK
    before, total = op.launches, sk.KERNEL_LAUNCHES["v3_f32"]
    loop.next.run()
    assert op.launches == before + n
    assert sk.KERNEL_LAUNCHES["v3_f32"] == total + n


def test_graphs_are_freed_on_cache_eviction(card):
    mesh, sysm, builder = _cantilever()
    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device=card)
    b = torch.as_tensor(sysm.b_hat, dtype=torch.float32, device=card)
    mg.mg_pcg(h, b, torch.zeros_like(b), 1e-6, 200)
    loop = next(iter(h.graphs._entries.values()))
    graph = weakref.ref(loop.first)
    del loop
    saved = dict(linsolve._MG_CACHE)
    linsolve._MG_CACHE.clear()
    try:
        linsolve._mg_cache_put("h", h, None)
        for i in range(linsolve._MG_CACHE_MAX):
            linsolve._mg_cache_put(i, h._replace(graphs=None), None)
        assert "h" not in linsolve._MG_CACHE
        assert len(h.graphs) == 0
        gc.collect()
        assert graph() is None
    finally:
        linsolve._MG_CACHE.clear()
        linsolve._MG_CACHE.update(saved)
