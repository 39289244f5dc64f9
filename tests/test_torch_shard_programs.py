"""The sharded loops as device programs (``parallel.shard``,
``parallel.shard_mg``), run eagerly on the CPU over virtual shards.

Each sharded solve is a masked loop run in blocks with one host read a
block (``HOST_READS["shard_cg"]``, ``["shard_mg"]``); each sharded scan a
step program with one read a chunk of steps (``["shard_scan"]``).  Every
program takes the iterations of the host loop it replaced (a copy of that
loop is kept here, reading ‖r‖² on the host every iteration) and gives its
fields bit for bit, run as it ships and under ``device_loop._uncaptured()``
(the two differ only on a card, where ``chip_smoke.shard_phase`` holds
them); the scans equal their per-step path step by step.  Shards on
several cards cannot share one CUDA graph: there the loops run uncaptured,
chosen by the mesh's devices and logged once.  The JAX package's sharded
solves hold all of them in ``tests/test_torch_parallel.py``."""

import logging
import math

import numpy as np
import pytest
import torch

from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu_torch.ops import (assembly, device_loop, linsolve,
                                      timestepping)
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.parallel import shard as psh
from pde_solver_tpu_torch.parallel import shard_mg
from pde_solver_tpu_torch.utils import kept
from pde_solver_tpu_torch.utils.observability import get_logger


@pytest.fixture
def cpu8(monkeypatch):
    """The port on the CPU over 8 virtual shard devices, scans cold."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "8")
    kept.clear_all()
    with config.config_overrides(device="cpu"):
        yield
    kept.clear_all()


def _host_pcg(apply_A, b, inv_diag, tol, maxiter, x0):
    """The sharded Jacobi-PCG as a host loop, reading ‖r‖² every
    iteration (what ``sharded_pcg`` was before it became a program)."""
    x = x0
    r = b - apply_A(x)
    z = r if inv_diag is None else r * inv_diag
    p = z
    rz = psh.pdot(r, z)
    bnorm2 = float(psh.pdot(b, b)) or 1.0
    tol2 = tol ** 2 * bnorm2
    rr = float(rz) if inv_diag is None else float(psh.pdot(r, r))
    k = 0
    while rr > tol2 and k < maxiter:
        Ap = apply_A(p)
        alpha = rz / psh._nonzero(psh.pdot(p, Ap))
        x = x + p * alpha
        r = r - Ap * alpha
        z = r if inv_diag is None else r * inv_diag
        rz_new = psh.pdot(r, z)
        p = z + p * (rz_new / psh._nonzero(rz))
        rz = rz_new
        k += 1
        rr = float(rz) if inv_diag is None else float(psh.pdot(r, r))
    return x, k


def _host_mg(solver, b_hat, tol, maxiter):
    """``ShardedMGSolver``'s flexible PCG as a host loop (its form before
    it became a program)."""
    A, M = solver.apply, solver._precondition
    b = solver._grid_put(b_hat)
    x = b.zeros_like()
    r = b - A(x)
    z = M(r)
    p = z
    rz = psh.pdot(r, z)
    bnorm2 = float(psh.pdot(b, b)) or 1.0
    tol2 = tol * tol * bnorm2
    k, rr = 0, float(psh.pdot(r, r))
    while rr > tol2 and k < maxiter:
        Ap = A(p)
        alpha = rz / psh._nonzero(psh.pdot(p, Ap))
        x = x + p * alpha
        r_new = r - Ap * alpha
        z = M(r_new)
        rz_new = psh.pdot(r_new, z)
        beta = torch.clamp((rz_new - psh.pdot(z, r)) / psh._nonzero(rz),
                           min=0.0)
        p = z + p * beta
        r, rz = r_new, rz_new
        k += 1
        rr = float(psh.pdot(r, r))
    return psh.gather(x)[:solver.nx], k


def _reads(kind, fn):
    """(fn's result, its host reads under ``kind``)."""
    device_loop.HOST_READS.clear()
    out = fn()
    return out, device_loop.HOST_READS.get(kind, 0)


def _blocks(k, block):
    """Reads of a masked loop that took k iterations: one a block run."""
    return max(1, math.ceil(k / block))


def _both(fn):
    """fn() as it ships, then under ``_uncaptured()``."""
    out = fn()
    with device_loop._uncaptured():
        return out, fn()


def test_heat_step_program_matches_the_host_loop(cpu8):
    """The sharded backward-Euler heat step's Jacobi-PCG on 8 shards (15
    planes: identity-row padding, a Dirichlet face): the program's
    iterations and u are the host loop's, bit for bit; one read a block,
    the program kept across steps."""
    m = rectangle_mesh(15, 6, (0.0, 0.0), (1.0, 1.0))
    bc = DirichletBC.from_masks([(m.face_mask(0, 0), 20.0)], m.node_shape)
    step, inputs = psh.build_sharded_heat_step(m, psh.device_mesh(8), 1.3,
                                               0.01, bc, tol=1e-7)
    u = np.random.default_rng(0).uniform(0.0, 20.0, m.node_shape)
    (out, reads), (out0, _) = _both(lambda: _reads("shard_cg",
                                                   lambda: step(u, *inputs)))
    x, k, _ = out
    assert torch.equal(x, out0[0]) and k == out0[1] > 0
    assert reads == _blocks(k, linsolve.CG_BLOCK)

    # the host loop on the same right side and diagonal
    A_w, M_w, free, gvals = inputs
    offsets = tuple(sorted(set(assembly.assemble_scalar_stencil(m, "mass"))
                           | set(assembly.assemble_scalar_stencil(
                               m, "stiffness"))))
    us = psh.shard(u, free.mesh, torch.float32)

    def apply_c(x):
        xf = x * free
        return psh.local_stencil_apply(offsets, A_w, xf) * free + (x - xf)

    zero = offsets.index((0, 0))
    inv_diag = (A_w[zero] * free + (1.0 - free)).map(
        lambda t: 1.0 / psh._nonzero(t))
    # the step solves on its free rows and puts the Dirichlet values back
    bt = free * (psh.local_stencil_apply(offsets, M_w, us)
                 - psh.local_stencil_apply(offsets, A_w, gvals))
    xh, kh = _host_pcg(apply_c, bt, inv_diag, 1e-7, 500, free * us)
    assert kh == k and torch.equal(psh.gather(xh + gvals), x)


@pytest.mark.parametrize("mesh_shape,cells,vdim", [
    ((8,), (13, 6), 1), ((4, 2), (13, 8), 1), ((4, 2), (9, 5, 4), 3)])
def test_scaled_cg_program_matches_the_host_loop(cpu8, mesh_shape, cells,
                                                 vdim):
    """``ShardedScaledCG.solve`` on a 1-D and an a×b mesh (padded both
    ways), scalar and block-scaled: the program's iterations and x̂ are the
    host loop's, bit for bit, one read a block of ``CG_BLOCK``; a second
    solve replays the kept program."""
    if vdim == 1:
        m = rectangle_mesh(*cells, (0.0, 0.0), (1.0, 1.0))
        K = assembly.assemble_scalar_stencil(m, "stiffness")
        bc = DirichletBC.from_masks([(m.face_mask(0, 0), 20.0),
                                     (m.face_mask(0, 1), 0.0)], m.node_shape)
        b = assembly.assemble_load(m)
    else:
        m = box_mesh(*cells, (0, 0, 0), (1.0, 0.4, 0.3))
        K = assembly.assemble_elasticity_stencil(m, 1.2e11, 8.1e10)
        bc = DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape,
                                    vdim=3)
        b = assembly.assemble_vector_load(m, np.array([0.0, 0.0, -7.65e4]))
    sysm = linsolve.prepare_system(K, m, bc, b, vdim)
    mesh = (psh.device_mesh(shape=mesh_shape) if len(mesh_shape) == 2
            else psh.device_mesh(mesh_shape[0]))
    cg = psh.ShardedScaledCG(sysm, m.dim, vdim, mesh)
    (out, reads), (out0, _) = _both(lambda: _reads(
        "shard_cg", lambda: cg.solve(tol=1e-6, maxiter=2000)))
    xh, k, _ = out
    assert torch.equal(xh, out0[0]) and k == out0[1] > 0
    assert reads == _blocks(k, linsolve.CG_BLOCK)
    b_s = cg.b_hat
    x_host, k_host = _host_pcg(cg.apply, b_s, None, 1e-6, 2000,
                               b_s.zeros_like())
    unpad = tuple(slice(0, n) for n in cg.ns)
    assert k_host == k and torch.equal(psh.gather(x_host)[unpad], xh)
    # one kept program: on the CPU the loop runs uncaptured both ways
    assert len(device_loop.store_of(cg)) == 1


def test_mg_program_matches_the_host_loop(cpu8):
    """``ShardedMGSolver.solve`` on a float64 hierarchy (33 planes over 8
    shards): the program's iterations and x̂ are the host loop's, bit for
    bit, one read a block of ``PCG_BLOCK``."""
    m = box_mesh(32, 8, 8, (0, 0, 0), (1.0, 1.0, 1.0))

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(mc.boundary_mask(), 0.0)],
                                       mc.node_shape))

    K, bc = builder(m)
    sysm = linsolve.prepare_system(K, m, bc, assembly.assemble_load(m), 1)
    h = mg.build_hierarchy(m, sysm, builder, device="cpu",
                           dtype=torch.float64, use_kernel=False)
    solver = shard_mg.ShardedMGSolver(h, psh.device_mesh(8))
    (out, reads), (out0, _) = _both(lambda: _reads(
        "shard_mg", lambda: solver.solve(sysm.b_hat, None, tol=1e-10,
                                         maxiter=200)))
    xh, k, relres = out
    assert torch.equal(xh, out0[0]) and k == out0[1] > 0 and relres <= 1e-10
    assert reads == _blocks(k, mg.PCG_BLOCK)
    x_host, k_host = _host_mg(solver, sysm.b_hat, 1e-10, 200)
    assert k_host == k and torch.equal(x_host, xh)


def _transient(vdim, steps):
    """A θ (vdim 1: heat with a driven face and source; CNAB2) or a
    Newmark (vdim 2) scan on 8 shards through ``run_transient`` /
    ``run_newmark``."""
    m = rectangle_mesh(21, 8, (0.0, 0.0), (1.0, 1.0))
    M = assembly.assemble_scalar_stencil(m, "mass")
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(m, "stiffness")
        bc = DirichletBC.from_masks([(m.face_mask(0, 0), 20.0)],
                                    m.node_shape)
        u0 = np.asarray(bc.apply_values(np.zeros(m.node_shape)))
        C = assembly.assemble_convection_stencil(m, (0.7, -0.2))

        def run():
            with config.config_overrides(shard_devices=8):
                return timestepping.run_transient(
                    K, M, m, bc, np.ones(u0.shape), u0, 1e-3, steps,
                    theta=0.5, C_np=C, convection_scheme="cnab2",
                    time_mod={"omega": 30.0, "source_amp": np.ones(u0.shape),
                              "bc_amp_values": 2.0 * np.ones(u0.shape)})
        return run
    from pde_solver_tpu_torch.models import elasticity

    lam, mu = elasticity.lame_parameters(1e6, 0.3, "plane_stress")
    K = assembly.assemble_elasticity_stencil(m, lam, mu)
    Mv = elasticity.assemble_vector_mass(m, 10.0)
    bc = DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)], m.node_shape,
                                vdim=2)
    free = np.asarray(bc.free_mask, np.float64)
    x = m.node_coords
    u0 = free * 1e-3 * np.sin(0.5 * np.pi * x[..., :1]) * np.ones(2)
    f = free * 50.0 * np.ones(u0.shape)

    def run():
        with config.config_overrides(shard_devices=8,
                                     transient_inner_tol=1e-8):
            return timestepping.run_newmark(K, Mv, m, bc, f, u0,
                                            np.zeros(u0.shape), 2e-4, steps,
                                            vdim=2)
    return run


@pytest.mark.parametrize("vdim", [1, 2])
def test_sharded_scan_programs_match_per_step(cpu8, vdim):
    """The sharded θ scan (CNAB2, sinusoidal driving) and Newmark scan,
    20 steps: as a step program, under ``_uncaptured()`` and per step,
    the same iterations and bit-equal frames; the program reads once a
    chunk after its first step, solved on its own."""
    steps = 20
    run = _transient(vdim, steps)

    def cold(ctx=None):
        kept.clear_all()
        device_loop.HOST_READS.clear()
        if ctx is None:
            res = run()
        else:
            with ctx():
                res = run()
        return res, dict(device_loop.HOST_READS)

    (res, reads), (res0, _), (per, per_reads) = (
        cold(), cold(device_loop._uncaptured), cold(device_loop._per_step))
    for other in (res0, per):
        assert res.total_cg_iterations == other.total_cg_iterations > 0
        assert np.array_equal(res.values, other.values)
        if vdim == 2:
            assert np.array_equal(res.velocities, other.velocities)
    assert res.scan_stepwise_chunks >= 1 and res.scan_programs_built >= 1
    assert reads.get("shard_scan", 0) == len(device_loop.scan_chunks(
        steps, first=True)) - res.scan_stepwise_chunks
    assert reads.get("shard_scan_redo", 0) == res.scan_reruns
    assert "shard_scan" not in per_reads and per_reads["shard_cg"] >= steps


def test_loops_capture_only_on_one_card(caplog):
    """A graph runs on one device: shards on one CUDA device capture, on
    several cards run uncaptured (logged once a mesh at INFO), on the CPU
    run eagerly; ``_uncaptured()`` turns the single-card capture off."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    one = psh.ShardMesh((cuda0,) * 4, (4,))
    two = psh.ShardMesh((cuda0, cuda0, cuda1, cuda1), (4,))
    assert psh.captures(one)
    with device_loop._uncaptured():
        assert not psh.captures(one)
    assert not psh.captures(psh.ShardMesh((torch.device("cpu"),) * 4, (4,)))
    logger = get_logger()
    prev, logger.propagate = logger.propagate, True
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            psh._SEVERAL_CARDS_LOGGED.clear()
            assert not psh.captures(two) and not psh.captures(two)
    finally:
        logger.propagate = prev
    lines = [r.getMessage() for r in caplog.records
             if "run uncaptured" in r.getMessage()]
    assert len(lines) == 1 and "2 cards" in lines[0]
