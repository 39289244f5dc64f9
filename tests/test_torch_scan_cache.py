"""A scan's operands, hierarchy and step programs kept across calls
(``timestepping._SCAN_CACHE``), the counterpart of ``jax.jit``'s cache on
the JAX package's ``_transient_scan`` / ``_newmark_scan``, run eagerly on
the CPU.

A follow-up with the same operator and a new Dirichlet value, initial field
or load builds no step program and solves no first step on its own: it
starts at the budget the first call learned.  Its iterations and frames
are those of a cold call of the same follow-up (the cache emptied first),
bit for bit, and still those of the JAX package's ``run_transient`` /
``run_newmark`` on the follow-up's inputs at the parity bounds of
``tests/test_torch_scan_graphs.py`` (its float64 ``run_transient``: the
port's θ-steps stop on their free rows).  A changed operator (Δt) misses; a
third operator of a kind evicts the least recent one and releases its
graphs; θ and Newmark scans key apart; the checkpointed and the sharded
scans keep theirs the same way."""

import numpy as np
import pytest

from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch import config
from pde_solver_tpu_torch.mesh import box_mesh
from pde_solver_tpu_torch.ops import assembly, device_loop, timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC
from pde_solver_tpu_torch.utils import kept
from test_torch_newmark_modal import _newmark_operands

STEPS = 20                    # one chunk of 16 and one of 4 after the first
F32 = dict(precision="f32", transient_inner_tol=1e-8)
MG = dict(mg_threshold=100, transient_mg_threshold=100)
F32_TOL = 1e-6                # test_torch_scan_graphs' bound to the JAX
NEWMARK_TOL = 2e-5            # package (elasticity blocks: 2e-5)


@pytest.fixture(autouse=True)
def _cold_scans():
    kept.clear_all()
    yield
    kept.clear_all()


def _gap(v, v_ref):
    return np.abs(v - v_ref).max() / np.abs(v_ref).max()


def _record_programs(monkeypatch):
    """The budgets of the step programs made after this call."""
    budgets = []

    class Recorded(device_loop.StepLoop):
        def __init__(self, step, program, carry, tol, maxiter, budget,
                     *rest):
            budgets.append(budget)
            super().__init__(step, program, carry, tol, maxiter, budget,
                             *rest)

    monkeypatch.setattr(device_loop, "StepLoop", Recorded)
    return budgets


def _heat(n, face=0.0, amp=1.0, dt=0.002, driven=False, cnab2=False):
    """A heat (or CNAB2 advection-diffusion) scan for both packages: the
    faces at ``face`` °C, an initial field ``amp`` × a seeded smooth
    bump; with ``driven`` a sinusoidal source and face temperature.
    Returns run(package, cfg) → result."""
    cells = (n, n, n)
    r_mesh = ref_mesh.StructuredMesh(cells, (0.0,) * 3, (1.0,) * 3)
    p_mesh = box_mesh(*cells, (0, 0, 0), (1.0, 1.0, 1.0))

    def ops(asm, msh, BC):
        return (asm.assemble_scalar_stencil(msh, "stiffness"),
                asm.assemble_scalar_stencil(msh, "mass"),
                BC.from_masks([(msh.boundary_mask(), face)], msh.node_shape))

    K, M, bc = ops(ref_asm, r_mesh, RefBC)
    free = np.asarray(bc.free_mask, np.float64)
    x = r_mesh.node_coords
    u0 = (free * amp * np.random.default_rng(5).uniform(0.5, 1.5)
          * np.prod(np.sin(np.pi * x), axis=-1)
          + (1.0 - free) * face)
    kw = dict(theta=0.5 if cnab2 else 1.0)
    if driven:
        kw["time_mod"] = {"omega": 40.0, "phase": 0.3,
                          "source_amp": np.ones(u0.shape),
                          "bc_amp_values": 0.5 * np.ones(u0.shape)}
    if cnab2:
        kw["C_np"] = ref_asm.assemble_convection_stencil(r_mesh,
                                                         (0.8, -0.3, 0.2))
        kw["convection_scheme"] = "cnab2"
    p_bc = DirichletBC(free, np.asarray(bc.values, np.float64))

    def run(pkg, cfg):
        mg = "mg_threshold" in cfg
        if pkg == "ref":
            with ref_config.config_overrides(**cfg):
                return ref_ts.run_transient(
                    K, M, r_mesh, bc, np.zeros(u0.shape), u0, dt, STEPS,
                    mg_level_builder=(lambda m: ops(ref_asm, m, RefBC))
                    if mg else None, **kw)
        with config.config_overrides(device="cpu", **cfg):
            return timestepping.run_transient(
                K, M, p_mesh, p_bc, np.zeros(u0.shape), u0, dt, STEPS,
                mg_level_builder=(lambda m: ops(assembly, m, DirichletBC))
                if mg else None, **kw)
    return run


def _follow_up(first, follow, cfg, monkeypatch, reads="scan"):
    """``first`` cold, then ``follow`` (the same operator, new values):
    the follow-up builds no step program and no first step on its own (its
    scan reads ``reads`` once a chunk), and equals a cold call of itself
    bit for bit.  Returns the follow-up."""
    res1 = first("port", cfg)
    assert not res1.scan_kept and res1.scan_programs_built >= 1
    assert res1.scan_stepwise_chunks >= 1
    budgets = _record_programs(monkeypatch)
    device_loop.HOST_READS.clear()
    res = follow("port", cfg)
    assert res.scan_kept and res.scan_programs_built == 0 and budgets == []
    assert res.scan_stepwise_chunks == 0 and res.scan_capture_seconds == 0.0
    # no first step on its own: one read a chunk of SCAN_CHUNK steps
    assert device_loop.HOST_READS.get(reads, 0) == len(
        device_loop.scan_chunks(STEPS))
    kept.clear_all()
    cold = follow("port", cfg)
    assert not cold.scan_kept and cold.scan_programs_built >= 1
    assert res.total_cg_iterations == cold.total_cg_iterations > 0
    assert np.array_equal(res.values, cold.values)
    assert res.max_relative_residual == cold.max_relative_residual
    if hasattr(res, "velocities"):
        assert np.array_equal(res.velocities, cold.velocities)
    return res


@pytest.mark.parametrize("case", ["MG-PCG driven", "flat CG", "CNAB2"])
def test_repeated_theta_scan_keeps_its_programs(case, monkeypatch):
    """A second ``run_transient`` with the same operator, a new face
    temperature and a new initial field: MG-PCG step solves with
    sinusoidal driving (``time_mod``) at 10³, flat CG at 8³, CNAB2
    advection with MG-PCG at 8³."""
    n, kw, cfg = {"MG-PCG driven": (10, dict(driven=True), dict(F32, **MG)),
                  "flat CG": (8, {}, F32),
                  "CNAB2": (8, dict(cnab2=True, dt=0.005),
                            dict(F32, **MG))}[case]
    follow = _heat(n, face=5.0, amp=0.4, **kw)
    res = _follow_up(_heat(n, **kw), follow, cfg, monkeypatch)
    # The JAX package's float32 scan stops each step on a norm that the
    # faces' 5 °C fill, so its follow-up lies up to 1.5e-6 off its own
    # float64 scan (flat CG); the port's steps stop on their free rows,
    # and its follow-up is held against that float64 scan
    ref = follow("ref", dict(cfg, precision="f64"))
    assert np.array_equal(res.times, ref.times)
    assert _gap(res.values, ref.values) <= F32_TOL
    with device_loop._per_step():
        per_step = follow("port", cfg)
    assert res.total_cg_iterations == per_step.total_cg_iterations


@pytest.mark.parametrize("solver", ["flat CG", "MG-PCG"])
def test_repeated_newmark_scan_keeps_its_programs(solver, monkeypatch):
    """A second ``run_newmark`` of the 8×4×4 cantilever with a new initial
    displacement, velocity and load."""
    o = _newmark_operands(3)
    cfg = dict(F32, **(MG if solver == "MG-PCG" else {}))

    def newmark(scale):
        def run(pkg, cfg):
            msh, bc, coarse = o[pkg]
            args = (o["K"], o["M"], msh, bc, scale * o["f"],
                    scale * o["u0"], -scale * o["v0"], o["dt"], STEPS)
            if pkg == "ref":
                with ref_config.config_overrides(**cfg):
                    return ref_ts.run_newmark(*args, vdim=3,
                                              mg_level_builder=coarse)
            with config.config_overrides(device="cpu", **cfg):
                return timestepping.run_newmark(*args, vdim=3,
                                                mg_level_builder=coarse)
        return run

    res = _follow_up(newmark(1.0), newmark(0.6), cfg, monkeypatch)
    ref = newmark(0.6)("ref", cfg)
    assert _gap(res.values, ref.values) <= NEWMARK_TOL
    assert _gap(res.velocities, ref.velocities) <= NEWMARK_TOL


def test_first_step_near_the_cap_starts_its_trajectory_at_the_cap(
        monkeypatch):
    """A first step of 25–32 iterations (float64 flat CG at 10³, Δt 0.05),
    whose count with a block to spare would pass ``STEP_BUDGET_MAX``: the
    next chunk runs on a program at the cap, not step by step, and a
    follow-up with a new initial field starts its trajectory there."""
    from test_torch_scan_graphs import _record_steps

    cfg = dict(precision="f64")
    first, follow = _heat(10, dt=0.05), _heat(10, amp=0.4, dt=0.05)
    cap, block = device_loop.STEP_BUDGET_MAX, device_loop.STEP_BLOCK
    with monkeypatch.context() as m:
        seen = _record_steps(m)
        budgets = _record_programs(m)
        res1 = first("port", cfg)
    assert cap - block < seen[0] <= cap < seen[0] + block
    assert budgets == [device_loop.first_budget(seen[0])] == [cap]
    assert res1.scan_stepwise_chunks == 1
    assert res1.scan_reruns == 0
    kept.clear_all()
    _follow_up(first, follow, cfg, monkeypatch)


def test_changed_operator_misses_and_third_evicts_the_first(monkeypatch):
    """Δt changes the implicit operator: each new Δt misses and builds its
    step programs; the third distinct operator evicts the least recent
    entry, whose step programs and hierarchy graphs are released; a
    Newmark entry is not touched by θ scans (the kinds key apart)."""
    cfg = dict(F32, **MG)
    o = _newmark_operands(3)
    msh, bc, coarse = o["port"]
    with config.config_overrides(device="cpu", **cfg):
        timestepping.run_newmark(o["K"], o["M"], msh, bc, o["f"], o["u0"],
                                 o["v0"], o["dt"], 3, vdim=3,
                                 mg_level_builder=coarse)
    (newmark_entry,) = timestepping._SCAN_CACHE["newmark"].values()
    entries = []
    for dt in (0.002, 0.003, 0.004):
        res = _heat(8, dt=dt)("port", cfg)
        assert not res.scan_kept and res.scan_programs_built >= 1
        entries.append(list(timestepping._SCAN_CACHE["theta"].values())[-1])
    theta = timestepping._SCAN_CACHE["theta"]
    assert len(theta) == theta.size == 2
    first, second, third = entries
    assert all(e is not first for e in theta.values())
    assert len(first.graphs) == 0 and len(first.h.graphs) == 0
    for entry in (second, third):
        assert len(entry.graphs) > 0
    # the least recent is the one a repeat brings back to the front
    assert _heat(8, dt=0.003)("port", cfg).scan_kept
    _heat(8, dt=0.005)("port", cfg)
    assert len(third.graphs) == 0 and len(second.graphs) > 0
    assert list(timestepping._SCAN_CACHE["newmark"].values()) == \
        [newmark_entry] and len(newmark_entry.graphs) > 0


def test_checkpointed_follow_up_keeps_its_programs(tmp_path, monkeypatch):
    """A checkpointed scan (chunks of 6 steps, each ending in a read)
    repeated with a new initial field keeps its programs and lands on a
    cold call of itself bit for bit."""
    ck = dict(F32, transient_checkpoint_every=6,
              checkpoint_dir=str(tmp_path))
    first, follow = _heat(8), _heat(8, face=2.0, amp=0.7)
    assert not first("port", ck).scan_kept
    budgets = _record_programs(monkeypatch)
    res = follow("port", ck)
    assert res.scan_kept and budgets == [] and res.scan_stepwise_chunks == 0
    kept.clear_all()
    cold = follow("port", ck)
    assert np.array_equal(res.values, cold.values)
    assert res.total_cg_iterations == cold.total_cg_iterations


@pytest.mark.parametrize("scan", ["theta", "newmark"])
def test_sharded_follow_up_keeps_its_programs(scan, monkeypatch):
    """The sharded scans (4 virtual shards) key the same way, the mesh's
    devices joining the key: a follow-up keeps the scan object and its
    step programs and lands on a cold call of itself bit for bit."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "4")
    cfg = dict(F32, shard_devices=4)
    if scan == "theta":
        first, follow = _heat(8, driven=True), _heat(8, face=3.0, amp=0.5,
                                                     driven=True)
    else:
        o = _newmark_operands(3)

        def newmark(scale):
            def run(pkg, cfg):
                msh, bc, _ = o["port"]
                with config.config_overrides(device="cpu", **cfg):
                    return timestepping.run_newmark(
                        o["K"], o["M"], msh, bc, scale * o["f"],
                        scale * o["u0"], scale * o["v0"], o["dt"], STEPS,
                        vdim=3)
            return run
        first, follow = newmark(1.0), newmark(0.5)
    _follow_up(first, follow, cfg, monkeypatch, reads="shard_scan")


def test_a_budget_first_wanted_runs_on_a_wider_kept_program():
    """A chunk whose budget has no program of its own: in the trajectory
    that learns the programs it is captured, the first time that budget is
    wanted (a capture costs less than a chunk run a rung or more wide);
    once a trajectory has run (``settled``) it runs on the smallest wider
    program kept (its answer is the same: any budget at or above a step's
    count gives it), and captures only when none is wider."""
    progs = device_loop.ScanPrograms()
    wide, wider = object(), object()
    progs.loops = {16: wide, 32: wider}
    assert progs.loop_for(8) is None          # learning: capture it
    assert progs.loop_for(16) is wide and progs.loop_for(32) is wider
    progs.settled = True
    assert progs.loop_for(8) is wide          # settled: the smallest wider
    assert progs.loop_for(24) is wider
    progs.loops = {8: wide}
    assert progs.loop_for(24) is None         # none wider: capture it
