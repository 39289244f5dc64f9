"""The port's solve loops as masked blocks (``ops.device_loop``), run
uncaptured on the CPU: ``mg_pcg``, ``_cg_unit_diag``, the double-float32
round's inner solves and ``solve_mg`` at blocks of 1, 3 and 16 iterations
and at their callers' blocks give the same iterations and bit-equal
solutions, which the JAX package's loops match within the port's
tolerances; masked iterations pass a finished state through unchanged;
replays count their launches; and a CPU rehearsal of
``chip_smoke.graphs_phase``."""

import math
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh
from pde_solver_tpu.ops import assembly
from pde_solver_tpu.ops import linsolve as ref_ls
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops.bc import DirichletBC
from pde_solver_tpu.ops.linsolve import prepare_system
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.ops import device_loop, linsolve
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk

LAM, MU = 1.2115384615384616e11, 8.076923076923077e10  # E=210e9, ν=0.3
BLOCKS = (1, 3, 16)
# a float32 solve of the port against the JAX package's, ·max|x|: the same
# iterations of the same operators, sums in another order.  At "f64" the
# port's tolerance for a float64 solve, 1e-9 relative
F32_TOL = 1e-6
F64_TOL = 1e-9


def _cantilever(cells=(16, 8, 8)):
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, LAM, MU),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    K, bc = builder(mesh)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    return mesh, prepare_system(K, mesh, bc, b, 3), builder


def _heat(n=16, dt=0.01):
    """The backward-Euler heat operator M + Δt K on the unit cube (17³
    nodes), all faces at 0, a right side from a seed."""
    mesh = box_mesh(n, n, n, (0, 0, 0), (1.0, 1.0, 1.0))

    def builder(mc):
        K = assembly.assemble_scalar_stencil(mc, "stiffness")
        M = assembly.assemble_scalar_stencil(mc, "mass")
        A = {o: M.get(o, 0.0) + dt * K.get(o, 0.0) for o in set(K) | set(M)}
        return A, DirichletBC.from_masks([(mc.boundary_mask(), 0.0)],
                                         mc.node_shape)

    A, bc = builder(mesh)
    b = np.random.default_rng(14).standard_normal(mesh.node_shape)
    return mesh, prepare_system(A, mesh, bc, b, 1), builder


def _carry(h_ref):
    """The JAX package's float32 hierarchy in the port (the same ω)."""
    levels = []
    for lv in h_ref.levels:
        scale = (dict(s=lv.host_scale[0]) if len(lv.host_scale) == 1
                 else dict(C=lv.host_scale[0], Cinv=lv.host_scale[1]))
        levels.append(dict(offsets=lv.offsets, weights=lv.host_weights,
                           free=np.asarray(lv.free), omega=lv.omega,
                           host_Ainv=lv.host_Ainv, **scale))
    return convert.hierarchy_from_numpy(
        levels, h_ref.grid_dim, h_ref.vdim, h_ref.pre_smooth,
        h_ref.post_smooth, h_ref.coarse_iters, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _blocks_agree(solve, blocks):
    """solve(block) at every block: one iteration count, bit-equal x."""
    runs = [solve(B) for B in blocks]
    x0, k0 = runs[0][0], runs[0][1]
    for (x, k, _), B in zip(runs, blocks):
        assert k == k0, (B, k, k0)
        assert torch.equal(x, x0), B
    return runs[0]


# (system, resync_every, the bound on x against the JAX package).  The
# heat operator is well conditioned: a solve to 1e-6 leaves both packages'
# x within F32_TOL.  The float32 cantilever is not: its x agrees only to
# what its conditioning leaves of the relres (3.8e-4 at 1e-6 and at 1e-5
# on the CPU, with the same iteration count, the preconditioners' bf16 and
# float32 smoothing apart).  With resync_every = 16 the port's float32
# cantilever stalls at 16×8×8 (ROADMAP queue 3), so it runs the transient
# steps' resync_every = 0 here; the df2 test holds the cantilever to
# F32_TOL at 1e-9.
MG_CASES = [("heat", 16, F32_TOL), ("heat", 0, F32_TOL),
            ("cantilever", 0, 1e-3)]


@pytest.mark.parametrize("system,resync_every,x_tol", MG_CASES)
def test_mg_pcg_blocks_agree_and_match_reference(system, resync_every,
                                                 x_tol):
    mesh, sysm, builder = (_heat() if system == "heat" else _cantilever())
    vdim = 1 if system == "heat" else 3
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=vdim,
                                   dtype=jnp.float32)
    h = _carry(h_ref)
    b32 = sysm.b_hat.astype(np.float32)
    b = torch.from_numpy(b32)
    own = mg.PCG_BLOCK if resync_every else mg.STEP_BLOCK
    x, k, relres = _blocks_agree(
        lambda B: mg.mg_pcg(h, b, torch.zeros_like(b), 1e-6, 200,
                            resync_every=resync_every, block=B),
        BLOCKS + (own,))
    xr, kr, rr = ref_mg.mg_pcg(h_ref, jnp.asarray(b32), jnp.zeros_like(b32),
                               1e-6, 200, resync_every=resync_every)
    assert relres <= 1e-6 and abs(k - int(kr)) <= 1, (k, int(kr))
    assert _rel(x, xr) <= x_tol


def test_flat_cg_blocks_agree_and_match_reference():
    mesh, sysm, _ = _heat()
    b32 = sysm.b_hat.astype(np.float32)
    b = torch.from_numpy(b32)
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=1, device="cpu")
    x, k, relres = _blocks_agree(
        lambda B: linsolve._cg_unit_diag(sysm.offsets, op, b,
                                         torch.zeros_like(b), 1e-6, 500, 3,
                                         1, block=B),
        BLOCKS + (linsolve.CG_BLOCK, linsolve.STEP_BLOCK))
    w = tuple(jnp.asarray(W, jnp.float32) for W in sysm.weights)
    xr, kr, rr = ref_ls._cg_unit_diag(sysm.offsets, w, jnp.asarray(b32),
                                      jnp.zeros_like(b32), 1e-6, 500, 3, 1)
    assert relres <= 1e-6 and abs(k - int(kr)) <= 1, (k, int(kr))
    assert _rel(x, xr) <= F32_TOL
    # one store entry a block size, each reused by a second solve
    assert len(device_loop.store_of(op)) == 5


def test_df2_inner_solves_blocks_agree_and_round_matches_reference():
    """The round's inner solve (a fixed ``inner_iters`` masked iterations,
    no read) equals ``mg_pcg`` with ``maxiter`` = ``inner_iters`` at every
    block on every level of the F-cycle's ascent; the whole df2 solve
    matches the JAX package's."""
    mesh, sysm, builder = _cantilever()
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32)
    h = _carry(h_ref)
    rng = np.random.default_rng(3)
    for m in range(len(h.levels) - 1):
        sub = h._replace(levels=h.levels[m:])
        rhs = torch.from_numpy(rng.standard_normal(
            tuple(sub.levels[0].free.shape)).astype(np.float32))
        rhs = rhs * sub.levels[0].free
        zero = torch.zeros_like(rhs)
        x_in, k_in, rr_in = mg._mg_pcg_inline(sub, rhs, zero, 1e-5, 10)
        x, k, relres = _blocks_agree(
            lambda B: mg.mg_pcg(sub, rhs, zero, 1e-5, 10, block=B),
            BLOCKS + (mg.PCG_BLOCK,))
        assert int(k_in) == k and torch.equal(x_in, x)
        assert float(rr_in) == relres
    lad_ref = ref_mg.build_df_ladder(h_ref, sysm, sysm.b_hat)
    xh_r, xl_r, it_r, rr_r = ref_mg.solve_fcycle_df2(h_ref, lad_ref, 1e-9)
    lad = mg.build_df_ladder(h, sysm, sysm.b_hat)
    out = [mg.solve_fcycle_df2(h, lad, 1e-9) for _ in range(2)]
    (x_hi, x_lo, it, rr), again = out
    # a second solve replays the stored programs: the same answer
    assert it == again[2] and torch.equal(x_hi, again[0])
    assert [key[0] for key in h.graphs._entries].count("df2") == 1
    assert rr <= 1e-9 and rr_r <= 1e-9
    assert abs(it - it_r) <= 0.1 * it_r, (it, it_r)
    x = x_hi.double() + x_lo.double()
    assert _rel(x, np.asarray(xh_r, np.float64)
                + np.asarray(xl_r, np.float64)) <= F32_TOL


def test_solve_mg_blocks_agree_and_match_reference():
    """The float64 ``solve_mg`` at 64×8×8: ``mg_pcg`` on the hierarchy
    without ``Ainv`` at every block equals it bit for bit; the JAX
    package's is within 1e-9."""
    mesh, sysm, builder = _cantilever((64, 8, 8))
    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device="cpu",
                           dtype=torch.float64)
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float64)
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-10, 200)
    no_ainv = h._replace(levels=tuple(lv._replace(Ainv=None)
                                      for lv in h.levels))
    b = torch.as_tensor(sysm.b_hat)
    x, kb, _ = _blocks_agree(
        lambda B: mg.mg_pcg(no_ainv, b, torch.zeros_like(b), 1e-10, 200,
                            block=B), BLOCKS)
    assert kb == k and torch.equal(x, xh)
    xh_ref, k_ref, _ = ref_mg.solve_mg(h_ref, sysm.b_hat, None, 1e-10, 200)
    assert relres <= 1e-10 and k > 0
    assert _rel(xh, np.asarray(xh_ref)) <= F64_TOL


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(a, b):
    return all(torch.equal(_bits(x), _bits(y)) if torch.is_tensor(x)
               else x == y for x, y in zip(a, b))


@pytest.mark.parametrize("why", ["converged", "maxiter"])
def test_masked_iterations_pass_a_finished_state_through(why):
    """A state that converged, or reached ``maxiter``, leaves every masked
    iteration exactly as it came, NaN and inf included: the next state is
    kept only where ``active`` holds (``torch.where``), never multiplied
    by 0."""
    mesh, sysm, builder = _heat(8)
    h = _carry(ref_mg.build_hierarchy(mesh, sysm, builder, vdim=1,
                                      dtype=jnp.float32))
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=1, device="cpu")
    b = torch.from_numpy(sysm.b_hat.astype(np.float32))
    programs = (mg._pcg_program(h, 16), linsolve._cg_program(
        sysm.offsets, op, 3, 1))
    for prologue, step, status, _ in programs:
        maxiter = 3 if why == "maxiter" else 500
        tol = 1e-30 if why == "maxiter" else 1e-5
        state = prologue(b, torch.zeros_like(b),
                         torch.tensor(tol, dtype=torch.float64),
                         torch.tensor(maxiter))
        g = 0
        while bool(state[6 if len(state) == 12 else 5]):
            state = step(state, g)
            g += 1
        # poison the search direction: an iteration that ran would carry
        # NaN and inf into x, r and the dots
        p = state[2].clone()
        p.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                       -float("inf")])
        state = state[:2] + (p,) + state[3:]
        done = tuple(t.clone() if torch.is_tensor(t) else t for t in state)
        st0 = status(done)
        for j in range(20):
            state = step(state, g + j)
        assert _same_state(state, done)
        assert torch.equal(status(state), st0) and not bool(st0[0])
        k = int(st0[1])
        assert (k == 3) if why == "maxiter" else (0 < k < 500)
        assert bool(torch.isfinite(state[0]).all())


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_launches_recorded_at_capture():
    """A launch recorded during a capture does not count; each replay adds
    what the capture recorded, by variant and to each operator."""
    mesh, sysm, _ = _heat(4)
    op = sk.FlatStencilOperator(sysm.offsets, sysm.weights, mesh.node_shape,
                                vdim=1, device="cpu")
    sk.reset_launch_counts()
    with device_loop._recording() as launches:
        for _ in range(3):
            sk.count_launch(op.variant, op)
        sk.count_launch("cs_apply_v1")
    assert sk.KERNEL_LAUNCHES == {} and op.launches == 0
    assert sk._CAPTURED is None
    assert sorted((v, n) for v, _, n in launches) == [("cs_apply_v1", 1),
                                                      ("v1_f32", 3)]
    prog = device_loop.Program(lambda g0, t: (t + 1,),
                               (torch.zeros(1),), capture=False)
    prog.graph, prog.launches = _FakeGraph(), tuple(launches)
    prog.run()
    prog.run()
    assert prog.graph.replays == 2
    assert sk.KERNEL_LAUNCHES == {"v1_f32": 6, "cs_apply_v1": 2}
    assert op.launches == 6
    # a recorded operator is held weakly: the program does not keep it
    ref = weakref.ref(op)
    del op
    assert ref() is None
    prog.run()
    assert sk.KERNEL_LAUNCHES == {"v1_f32": 9, "cs_apply_v1": 3}
    sk.reset_launch_counts()


def test_a_capture_refuses_a_block_off_the_resync_period(monkeypatch):
    """A captured block replays at every block start, so the resync must
    fall on the same positions of each: a block that is not a multiple of
    the period is refused where it would be captured."""
    monkeypatch.setattr(device_loop, "captures", lambda device: True)
    with pytest.raises(ValueError, match="multiple of the resync period"):
        device_loop.solve(device_loop.GraphStore(), ("mg_pcg",),
                          (None, None, None, None), torch.zeros(2),
                          torch.zeros(2), 1e-6, 100, 24, 16)


def test_graphs_phase_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.graphs_phase`` on the CPU at small sizes: every pair
    agrees (both runs are uncaptured here), reads are one a block."""
    import chip_smoke
    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.ops import multigrid as port_mg

    monkeypatch.setenv("PDE_TPU_CACHE_DIR", str(tmp_path / "cache"))
    data_dir = str(tmp_path / "data")
    flagship = dict(chip_smoke.FLAGSHIP, nx=16, ny=8, nz=8)
    heat = dict(nx=10, ny=10, nz=10, num_steps=3)
    modal = dict(nx=16, ny=4, nz=4, num_modes=2)
    walls = {}

    def counted(label, fn):
        sk.reset_launch_counts()
        device_loop.HOST_READS.clear()
        res = fn()
        walls[label] = 1.0
        return res, dict(sk.KERNEL_LAUNCHES), 1.0

    refs = {}
    with config_overrides(device="cpu", precision="mixed", mg_threshold=100,
                          transient_mg_threshold=100,
                          host_direct_threshold=0):
        res, launches, _ = counted("heat PDE_TPU_CS=0", lambda:
                                   api.solve_heat_3D(**heat,
                                                     data_dir=data_dir))
        refs["heat"] = dict(T=chip_smoke.field(res)[0],
                            stats=res.meta["solver_stats"],
                            launches=launches,
                            reads=dict(device_loop.HOST_READS),
                            peak=float("nan"))
        linsolve._MG_CACHE.clear()
        res, launches, _ = counted("solve_elasticity_3D_modal", lambda:
                                   api.solve_elasticity_3D_modal(
                                       **modal, data_dir=data_dir))
        refs["modal"] = dict(freqs=np.asarray(res.meta["frequencies_hz"]),
                             shapes=chip_smoke.field(res)[0],
                             stats=res.meta["solver_stats"],
                             launches=launches,
                             reads=dict(device_loop.HOST_READS),
                             peak=float("nan"))
        linsolve._MG_CACHE.clear()
        mesh, sysm, builder = _cantilever((16, 8, 8))
        refs["h_f64"] = port_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                                device="cpu",
                                                dtype=torch.float64)
        refs["b_f64"] = sysm.b_hat
        out = chip_smoke.graphs_phase(api, counted, data_dir, "cpu", refs,
                                      walls, {}, flagship=flagship, heat=heat,
                                      heat_steps=heat["num_steps"],
                                      modal=modal, device="cpu",
                                      profiled=False)
    linsolve._MG_CACHE.clear()
    assert set(out) == {"flagship mixed df2", "flagship f64 solve_mg",
                        "heat 3D scan", "modal 3D", "projection flat CG",
                        "planted_fault_raised"}
    for label, row in out.items():
        if label != "planted_fault_raised":
            assert row["gap"] == 0.0 and row["iterations"] > 0, label
    k = out["flagship f64 solve_mg"]["iterations"]
    assert out["flagship f64 solve_mg"]["runs"]["captured"]["reads"] == {
        "mg_pcg": math.ceil(k / port_mg.PCG_BLOCK)}
    assert not refs
