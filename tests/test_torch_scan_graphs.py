"""The scans as step programs (``device_loop.StepLoop``, ``run_scan``), run
eagerly on the CPU: each transient and Newmark path (MG-PCG and flat-CG
step solves, sinusoidal driving, CNAB2, "f64", checkpointed resume) gives
the per-step path's iterations step by step and bit-equal frames; the
first step is solved on its own and sets the budget, and the host then
reads once a chunk of ``SCAN_CHUNK`` steps, plus a counted rerun when a
step outruns the budget (forced here to 1 and 2); steps past
``STEP_BUDGET_MAX`` (a step run to maxiter) are solved step by step, with
no program captured larger; and the scans match the
JAX package's ``run_transient`` / ``run_newmark`` within the tolerances of
``tests/test_torch_transient.py`` and ``tests/test_torch_newmark_modal.py``.
"""

import math

import numpy as np
import pytest
import torch

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

STEPS = 20                    # two chunks: 16 + 4
F32 = dict(precision="f32", transient_inner_tol=1e-8)
MG = dict(mg_threshold=100, transient_mg_threshold=100)
# a float32 scan against the JAX package's (test_torch_transient), a
# float64 one (test_torch_precision)
F32_TOL, F64_TOL = 1e-6, 1e-9


@pytest.fixture(autouse=True)
def _cold_scans():
    """Each scan here starts cold: the scan cache (operands, hierarchy and
    step programs kept across calls, ``timestepping._SCAN_CACHE``) is
    emptied first; ``tests/test_torch_scan_cache.py`` holds the kept
    programs."""
    kept.clear_all()


def _gap(v, v_ref):
    return np.abs(v - v_ref).max() / np.abs(v_ref).max()


def _heat(n, dt=0.002, theta=1.0, convection=None, driven=True):
    """A heat (or advection-diffusion) scan's operands for both packages:
    (args, kwargs, port mesh + bc + builder, reference mesh + bc +
    builder), the faces at 0 °C, a smooth seeded initial field, and with
    ``driven`` a sinusoidal source and face temperature."""
    cells = (n, n, n)
    r_mesh = ref_mesh.StructuredMesh(cells, (0.0,) * 3, (1.0,) * 3)
    p_mesh = box_mesh(*cells, (0, 0, 0), (1.0, 1.0, 1.0))

    def ops(asm, msh, BC):
        return (asm.assemble_scalar_stencil(msh, "stiffness"),
                asm.assemble_scalar_stencil(msh, "mass"),
                BC.from_masks([(msh.boundary_mask(), 0.0)], msh.node_shape))

    K, M, bc = ops(ref_asm, r_mesh, RefBC)
    free = np.asarray(bc.free_mask, np.float64)
    x = r_mesh.node_coords
    amp = np.random.default_rng(5).uniform(0.5, 1.5, 2)
    u0 = free * amp[0] * np.prod(np.sin(np.pi * x), axis=-1)
    kw = dict(theta=theta)
    if driven:
        kw["time_mod"] = {"omega": 40.0, "phase": 0.3,
                          "source_amp": amp[1] * np.ones(u0.shape),
                          "bc_amp_values": 0.5 * np.ones(u0.shape)}
    if convection is not None:
        kw["C_np"] = ref_asm.assemble_convection_stencil(r_mesh, convection)
        kw["convection_scheme"] = "cnab2"
    args = (K, M, np.zeros(u0.shape), u0, dt, STEPS)
    return (args, kw,
            (p_mesh, DirichletBC(free, np.asarray(bc.values, np.float64)),
             lambda m: ops(assembly, m, DirichletBC)),
            (r_mesh, bc, lambda m: ops(ref_asm, m, RefBC)))


def _record_steps(monkeypatch):
    """{global step: iterations} of the scans run after this call (a rerun
    writes its chunk's steps again), and the host reads made before the
    first scan began (under "before")."""
    seen = {}
    run_scan = device_loop.run_scan

    def spy(store, key, step, *rest):
        seen.setdefault("before", dict(device_loop.HOST_READS))

        def recorded(c, n, solve):
            out = step(c, n, solve)
            seen[int(n)] = int(out[1])
            return out
        return run_scan(store, key, recorded, *rest)

    monkeypatch.setattr(device_loop, "run_scan", spy)
    return seen


def _record_budgets(monkeypatch):
    """The budgets of the step programs made after this call, in order."""
    budgets = []

    class Recorded(device_loop.StepLoop):
        def __init__(self, step, program, carry, tol, maxiter, budget,
                     *rest):
            budgets.append(budget)
            super().__init__(step, program, carry, tol, maxiter, budget,
                             *rest)

    monkeypatch.setattr(device_loop, "StepLoop", Recorded)
    return budgets


def _both(monkeypatch, run):
    """``run()`` through the step program and through the per-step path:
    {path: (result, {step: iterations}, host reads of the scans)}."""
    out = {}
    for path in ("program", "per step"):
        with monkeypatch.context() as m:
            seen = _record_steps(m)
            device_loop.HOST_READS.clear()
            if path == "per step":
                with device_loop._per_step():
                    res = run()
            else:
                res = run()
            before = seen.pop("before")
            reads = {k: n - before.get(k, 0)
                     for k, n in device_loop.HOST_READS.items()}
            out[path] = (res, dict(seen), {k: n for k, n in reads.items()
                                           if n})
    return out


def _hold_paths(out, steps=STEPS, newmark=False):
    """The step program against the per-step path: the iterations of every
    step, bit-equal frames; one read a chunk run by the step program, plus
    the reruns; the chunks with no budget (the first step's, and those
    after a step past the cap) read as their solves do."""
    (res, seen, reads), (res0, seen0, reads0) = (out["program"],
                                                 out["per step"])
    assert seen == seen0 and len(seen) == steps
    assert res.total_cg_iterations == res0.total_cg_iterations \
        == sum(seen.values()) > 0
    assert np.array_equal(res.values, res0.values)
    if newmark:
        assert np.array_equal(res.velocities, res0.velocities)
    assert res.max_relative_residual == res0.max_relative_residual
    chunks = device_loop.scan_chunks(steps, first=True)
    assert len(chunks) == 1 + math.ceil((steps - 1) / device_loop.SCAN_CHUNK)
    assert res.scan_stepwise_chunks >= 1
    assert reads.get("scan", 0) == len(chunks) - res.scan_stepwise_chunks
    assert reads.get("scan_redo", 0) == res.scan_reruns
    if res.scan_reruns == 0 and res.scan_stepwise_chunks == 1:
        first = [n for k, n in reads.items() if k != "scan"]
        assert first == [max(1, math.ceil(seen[0] / device_loop.STEP_BLOCK))]
    assert "scan" not in reads0 and res0.scan_reruns == 0
    return res


def _port_transient(case, cfg):
    args, kw, (mesh, bc, builder), _ = case
    K, M, b, u0, dt, n = args

    def run():
        with config.config_overrides(device="cpu", **cfg):
            return timestepping.run_transient(
                K, M, mesh, bc, b, u0, dt, n,
                mg_level_builder=builder if "mg_threshold" in cfg else None,
                **kw)
    return run


def _ref_transient(case, cfg):
    args, kw, _, (mesh, bc, builder) = case
    K, M, b, u0, dt, n = args
    with ref_config.config_overrides(**cfg):
        return ref_ts.run_transient(
            K, M, mesh, bc, b, u0, dt, n,
            mg_level_builder=builder if "mg_threshold" in cfg else None,
            **kw)


@pytest.mark.parametrize("solver", ["MG-PCG", "flat CG"])
def test_driven_heat_scan_matches_per_step_and_reference(solver,
                                                         monkeypatch):
    """Heat with a sinusoidal source and face temperature, 20 steps at
    float32: MG-PCG step solves at 16³, flat CG at 10³."""
    cfg = dict(F32, **(MG if solver == "MG-PCG" else {}))
    case = _heat(16 if solver == "MG-PCG" else 10)
    out = _both(monkeypatch, _port_transient(case, cfg))
    res = _hold_paths(out)
    ref = _ref_transient(case, cfg)
    assert np.array_equal(res.times, ref.times)
    assert _gap(res.values, ref.values) <= F32_TOL
    # the port's steps stop on their free rows, the JAX package's on a
    # norm the Dirichlet values fill: the count is the port's per-step one
    assert res.total_cg_iterations == out["per step"][0].total_cg_iterations


def test_cnab2_advection_scan_matches_per_step_and_reference(monkeypatch):
    """Advection-diffusion by CNAB2 (the carry holds the previous state)
    with MG-PCG step solves."""
    cfg = dict(F32, **MG)
    case = _heat(8, dt=0.005, theta=0.5, convection=(0.8, -0.3, 0.2),
                 driven=False)
    res = _hold_paths(_both(monkeypatch, _port_transient(case, cfg)))
    ref = _ref_transient(case, cfg)
    assert _gap(res.values, ref.values) <= F32_TOL


def test_f64_scan_learns_its_budget(monkeypatch):
    """At "f64" a step takes more iterations than one block: the first
    step, solved on its own, sets the budget to the ladder's rung at or
    above its count with one block to spare, 24 iterations (three
    blocks); the last chunk runs at the rung above the first chunk's worst
    step, and no chunk needs a rerun; within 1e-9 of the JAX package's
    float64 scan."""
    cfg = dict(precision="f64", **MG)
    case = _heat(16, dt=0.01)
    budgets = _record_budgets(monkeypatch)
    out = _both(monkeypatch, _port_transient(case, cfg))
    res = _hold_paths(out)
    first = out["program"][1][0]
    assert 2 * device_loop.STEP_BLOCK >= first > device_loop.STEP_BLOCK
    assert res.scan_reruns == 0
    block = device_loop.STEP_BLOCK
    worst = max(out["program"][1][j] for j in range(1, 17))
    assert budgets == [device_loop.first_budget(first),
                       device_loop.step_budget(worst)]
    assert budgets[0] == 3 * block > budgets[1]
    ref = _ref_transient(case, cfg)
    assert _gap(res.values, ref.values) <= F64_TOL
    # the port's steps stop on their free rows, the JAX package's on a
    # norm the Dirichlet values fill: the count is the port's per-step one
    assert res.total_cg_iterations == out["per step"][0].total_cg_iterations


# The budgets the ladder gives, written out: (the most iterations a chunk's
# worst step may take, the next chunk's budget); past the last, no budget
NEXT_BUDGET = ((0, 1), (1, 2), (2, 3), (3, 4), (5, 6), (7, 8), (11, 12),
               (15, 16), (23, 24), (32, 32))
# the same for a trajectory's first chunk, after its first step alone
FIRST_BUDGET = ((0, 8), (4, 12), (8, 16), (16, 24), (32, 32))


def _rung(table, k):
    return next((b for most, b in table if k <= most), None)


@pytest.mark.parametrize("k", range(41))
def test_step_budget_is_the_next_rung_with_a_spare_iteration(k):
    """The budget after a chunk whose worst step took ``k`` iterations is
    the ladder's rung at or above k + 1 (k + ``STEP_BLOCK`` for a first
    chunk), at most the cap; past the cap none (step by step)."""
    cap = device_loop.STEP_BUDGET_MAX
    budget, first = device_loop.step_budget(k), device_loop.first_budget(k)
    assert budget == _rung(NEXT_BUDGET, k)
    assert first == _rung(FIRST_BUDGET, k)
    if k > cap:
        assert budget is first is None
    else:
        assert {budget, first} <= set(device_loop.STEP_BUDGETS)
        assert budget >= min(k + 1, cap) and first >= min(k + 8, cap)
        assert first >= budget


@pytest.mark.parametrize("budget", [1, 2])
def test_forced_budget_overflows_reruns_and_lands_bit_equal(budget,
                                                            monkeypatch):
    """A budget forced to 1 or 2 iterations: the step program overflows,
    every chunk runs again step by step and is counted, and the scan lands
    bit for bit on the per-step path's."""
    for rule in ("first_budget", "step_budget"):
        monkeypatch.setattr(device_loop, rule, lambda k: budget)
    budgets = _record_budgets(monkeypatch)
    case = _heat(12)
    res = _hold_paths(_both(monkeypatch,
                            _port_transient(case, dict(F32, **MG))))
    assert budgets == [budget]
    assert res.scan_reruns == len(device_loop.scan_chunks(STEPS - 1))


def _rod(steps, dt=0.05, **cfg):
    """BASELINE 1's rod (255 cells, Δt = 0.05 unless ``dt``, ends at 20 and
    0 °C, flat CG step solves) as a scan of ``steps`` steps."""
    from pde_solver_tpu_torch.mesh import interval_mesh

    mesh = interval_mesh(255, 0.0, 2.0)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 20.0),
                                 (mesh.face_mask(0, 1), 0.0)],
                                mesh.node_shape)
    u0 = np.asarray(bc.apply_values(np.zeros(mesh.node_shape)))

    def run():
        with config.config_overrides(device="cpu", precision="f32", **cfg):
            return timestepping.run_transient(K, M, mesh, bc,
                                              np.zeros(u0.shape), u0, dt,
                                              steps)
    return run


def test_budget_follows_a_decaying_step_count(monkeypatch):
    """The rod's first steps take up to ~170 iterations, then ~26 until its
    field has settled, then none.  Each chunk after one whose worst step
    passed the cap runs step by step and captures nothing; the first chunk
    within it is run at the cap, and once the steps fall to none the budget
    falls to one iteration, the ladder's first rung; no rerun, and
    bit-equal to the per-step path all the same.  (At Δt = 0.05 and the
    default tolerance the rod's steps, stopped on their free rows, hover
    at 30–42 iterations until they drop to none, so no chunk's worst falls
    within the cap; Δt = 0.02 and a tolerance of 1e-5 put its middle steps
    at 26–27.)"""
    steps = 160
    budgets = _record_budgets(monkeypatch)
    out = _both(monkeypatch, _rod(steps, dt=0.02, transient_inner_tol=1e-5))
    res = _hold_paths(out, steps=steps)
    seen = out["program"][1]
    cap, chunk = device_loop.STEP_BUDGET_MAX, device_loop.SCAN_CHUNK
    assert seen[0] > 4 * cap
    assert budgets == [cap, device_loop.step_budget(0)] == [cap, 1]
    worst = [seen[0]] + [max(seen[j] for j in range(j0, min(j0 + chunk,
                                                            steps)))
                         for j0 in range(1, steps, chunk)]
    assert res.scan_reruns == 0
    assert res.scan_stepwise_chunks == 1 + sum(k > cap for k in worst[:-1])
    # the later steps run one iteration each, not the cap
    assert 0 < res.scan_past_iterations < (steps - 1) * cap / 2


def _settling_heat(steps):
    """A 16³ box whose faces hold 50 °C from a start of 25 °C, Δt 0.01,
    MG-PCG steps at float32 and the default step tolerance, as the 3D heat
    tool's follow-ups run: its steps take 4–5 iterations, then fewer as
    the field settles, then 1 or none."""
    mesh = box_mesh(16, 16, 16, (0, 0, 0), (1.0, 1.0, 1.0))

    def ops(m):
        return (assembly.assemble_scalar_stencil(m, "stiffness"),
                assembly.assemble_scalar_stencil(m, "mass"),
                DirichletBC.from_masks([(m.boundary_mask(), 50.0)],
                                       m.node_shape))

    K, M, bc = ops(mesh)
    u0 = np.asarray(bc.apply_values(np.full(mesh.node_shape, 25.0)))

    def run():
        with config.config_overrides(device="cpu", precision="f32", **MG):
            return timestepping.run_transient(K, M, mesh, bc,
                                              np.zeros(u0.shape), u0, 0.01,
                                              steps, mg_level_builder=ops)
    return run


def test_settling_heat_runs_its_later_chunks_at_their_steps(monkeypatch):
    """As a heat trajectory settles, each chunk runs at the ladder's rung
    one above the worst step of the chunk before, not in blocks of 8: the
    chunks after steps of 1–2 iterations run at a budget of 2 or 3, with
    no rerun, bit-equal to the per-step path."""
    steps = 1 + 5 * device_loop.SCAN_CHUNK
    ran = []
    run = device_loop.StepLoop.run

    def recorded(self, carry, n, m, keep, j0):
        ran.append((j0, m, self.budget))
        return run(self, carry, n, m, keep, j0)

    monkeypatch.setattr(device_loop.StepLoop, "run", recorded)
    out = _both(monkeypatch, _settling_heat(steps))
    res = _hold_paths(out, steps=steps)
    seen = out["program"][1]
    assert res.scan_reruns == 0 and res.scan_stepwise_chunks == 1
    assert seen[0] >= 4 and min(seen.values()) <= 1
    # every chunk at the rung above the worst step of the chunk before
    worst = [seen[0]] + [max(seen[j] for j in range(j0, j0 + m))
                         for j0, m, _ in ran]
    assert [b for _, _, b in ran] == (
        [device_loop.first_budget(worst[0])]
        + [device_loop.step_budget(k) for k in worst[1:-1]])
    later = [b for (_, _, b), k in zip(ran[1:], worst[1:]) if k <= 2]
    assert later and max(later) <= 3
    assert res.scan_past_iterations == sum(
        m * b for _, m, b in ran) - sum(seen[j] for j in range(1, steps))


def test_a_step_capped_at_maxiter_captures_no_larger_budget(monkeypatch):
    """Every step of the rod stops at maxiter (64, short of a tolerance the
    steps reach: a float32 step stops no tighter than
    ``linsolve.F32_TOL_FLOOR``, which the rod's first steps reach in
    84–100 iterations), past the budget's cap: every chunk runs step by
    step, no step program is captured, and the scan lands on the per-step
    path's."""
    steps, maxiter = 20, 64
    budgets = _record_budgets(monkeypatch)
    out = _both(monkeypatch, _rod(steps, maxiter=maxiter,
                                  transient_inner_tol=1e-30))
    res = _hold_paths(out, steps=steps)
    assert set(out["program"][1].values()) == {maxiter}
    assert maxiter > device_loop.STEP_BUDGET_MAX and budgets == []
    assert res.scan_reruns == 0 and res.scan_stepwise_chunks == len(
        device_loop.scan_chunks(steps, first=True))
    assert res.total_cg_iterations == steps * maxiter


@pytest.mark.parametrize("solver", ["flat CG", "MG-PCG"])
def test_newmark_scan_matches_per_step_and_reference(solver, monkeypatch):
    """Ten Newmark steps of the 8×4×4 cantilever (u, v, a carried)."""
    o = _newmark_operands(3)
    cfg = dict(F32, **(MG if solver == "MG-PCG" else {}))

    def run():
        msh, bc, coarse = o["port"]
        with config.config_overrides(device="cpu", **cfg):
            return timestepping.run_newmark(
                o["K"], o["M"], msh, bc, o["f"], o["u0"], o["v0"], o["dt"],
                10, vdim=3, mg_level_builder=coarse)

    res = _hold_paths(_both(monkeypatch, run), steps=10, newmark=True)
    msh, bc, coarse = o["ref"]
    with ref_config.config_overrides(**cfg):
        ref = ref_ts.run_newmark(o["K"], o["M"], msh, bc, o["f"], o["u0"],
                                 o["v0"], o["dt"], 10, vdim=3,
                                 mg_level_builder=coarse)
    # test_torch_newmark_modal's bound for elasticity blocks
    assert _gap(res.values, ref.values) <= 2e-5
    assert _gap(res.velocities, ref.velocities) <= 2e-5
    assert abs(res.total_cg_iterations - ref.total_cg_iterations) \
        <= 0.05 * ref.total_cg_iterations + 2


@pytest.mark.parametrize("scan", ["transient", "newmark"])
def test_checkpointed_resume_is_bit_equal(scan, tmp_path, monkeypatch):
    """A checkpointed scan aborted after its first chunk and resumed: the
    sinusoid is read at the global step, the carry at full precision, so
    the trajectory is bit-equal to the uncheckpointed per-step run."""
    ck = dict(transient_checkpoint_every=6, checkpoint_dir=str(tmp_path))
    if scan == "transient":
        case = _heat(10)

        def run(**extra):
            return _port_transient(case, dict(F32, **extra))()
    else:
        o = _newmark_operands(3)

        def run(**extra):
            msh, bc, coarse = o["port"]
            with config.config_overrides(device="cpu", **F32, **extra):
                return timestepping.run_newmark(
                    o["K"], o["M"], msh, bc, o["f"], o["u0"], o["v0"],
                    o["dt"], 14, vdim=3, mg_level_builder=coarse)

    with device_loop._per_step():
        plain = run()
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with pytest.raises(RuntimeError, match="checkpoint test abort"):
        run(**ck)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    device_loop.HOST_READS.clear()
    resumed = run(**ck)
    assert list(tmp_path.glob("*.npz")) == []
    assert np.array_equal(resumed.values, plain.values)
    assert np.array_equal(resumed.times, plain.times)
    if scan == "newmark":
        assert np.array_equal(resumed.velocities, plain.velocities)
    # the resumed chunks, each ending on a read (the first step of the
    # resumed run, solved on its own, reads as its solve)
    done = 6
    n = len(plain.times) - 1
    assert device_loop.HOST_READS["scan"] == math.ceil((n - done) / 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sinusoid_table_is_the_host_scalar(dtype):
    """The step program reads the driving's weights from a table in the
    state's dtype: each product equals the host float64 scalar's bit for
    bit (the scalar rounds to the tensor's dtype)."""
    omega, phase, dt, theta = 40.0, 0.3, 0.002, 0.5
    table = timestepping._sinusoid_table(omega, phase, dt, theta, STEPS)
    tab = torch.tensor(table, dtype=dtype)
    b1 = torch.as_tensor(np.random.default_rng(1).standard_normal(257),
                         dtype=dtype)
    for n in range(STEPS):
        s_n = math.sin(omega * (n * dt) + phase)
        s_np1 = math.sin(omega * (n * dt + dt) + phase)
        w = timestepping._row(tab, torch.tensor(n))
        assert torch.equal(w, timestepping._row(tab, n))
        assert torch.equal(w[0] * b1,
                           (theta * s_np1 + (1.0 - theta) * s_n) * b1)
        assert torch.equal(w[1] * b1, s_np1 * b1)
