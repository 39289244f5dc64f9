"""Multigrid of the port against the JAX package: transfers in float64, one
V-cycle on an identical (carried-over) hierarchy, and the double-float32
F-cycle solve on a small cantilever."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh, rectangle_mesh
from pde_solver_tpu.ops import assembly, pallas_kernels
from pde_solver_tpu.ops import multigrid as ref_mg
from pde_solver_tpu.ops.bc import DirichletBC
from pde_solver_tpu.ops.linsolve import prepare_system
from pde_solver_tpu_torch import convert
from pde_solver_tpu_torch.ops import multigrid as mg
from pde_solver_tpu_torch.ops import stencil_kernels as sk

LAM, MU = 1.2115384615384616e11, 8.076923076923077e10  # E=210e9, ν=0.3


def _cantilever(cells=(16, 8, 8)):
    """A gravity-loaded cantilever clamped at x = 0: a 3D bar, or with two
    cell counts a plane-strain plate (vdim=2, the 2D elasticity path)."""
    d = len(cells)
    if d == 3:
        mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))
    else:
        mesh = rectangle_mesh(*cells, (0, 0), (1.0, 0.5))
    K = assembly.assemble_elasticity_stencil(mesh, LAM, MU)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=d)
    b = assembly.assemble_vector_load(
        mesh, np.array([0.0, 0.0, -9.81 * 7800])[-d:])
    sysm = prepare_system(K, mesh, bc, b, d)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, LAM, MU),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=d))
    return mesh, sysm, builder


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("shape_c", [(5,), (5, 4), (4, 3, 3), (4, 3, 3, 3)])
def test_transfers_match_reference_and_are_adjoint(shape_c):
    d = min(len(shape_c), 3)
    rng = np.random.default_rng(0)
    shape_f = tuple(2 * s - 1 for s in shape_c[:d]) + shape_c[d:]
    u_c = rng.standard_normal(shape_c)
    v_f = rng.standard_normal(shape_f)
    Pu = mg.prolong(torch.from_numpy(u_c), d)
    Rv = mg.restrict(torch.from_numpy(v_f), d)
    assert _rel(Pu, ref_mg.prolong(jnp.asarray(u_c), d)) <= 1e-12
    assert _rel(Rv, ref_mg.restrict(jnp.asarray(v_f), d)) <= 1e-12
    lhs = float((Pu.numpy() * v_f).sum())
    rhs = float((u_c * Rv.numpy()).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_hat_transfers_match_reference_f64():
    mesh, sysm, builder = _cantilever((8, 4, 4))
    h = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                               dtype=jnp.float64)
    fine, coarse = h.levels[0], h.levels[1]

    def t(a):
        return torch.from_numpy(np.array(a))

    def port_level(lv):
        C, Cinv = lv.host_scale
        return mg.MGLevel(lv.offsets, None, t(np.asarray(lv.free)), 1.0,
                          None, t(C), t(Cinv))

    pf, pc = port_level(fine), port_level(coarse)
    rng = np.random.default_rng(1)
    r = rng.standard_normal(np.asarray(fine.free).shape)
    e = rng.standard_normal(np.asarray(coarse.free).shape)
    assert _rel(mg._restrict_hat(pf, pc, t(r), 3, 3),
                ref_mg._restrict_hat(fine, coarse, jnp.asarray(r), 3, 3)) <= 1e-12
    assert _rel(mg._prolong_hat(pf, pc, t(e), 3, 3),
                ref_mg._prolong_hat(fine, coarse, jnp.asarray(e), 3, 3)) <= 1e-12
    fs = tuple(map(t, fine.host_scale))
    cs = tuple(map(t, coarse.host_scale))
    ref_fs = tuple(map(jnp.asarray, fine.host_scale))
    ref_cs = tuple(map(jnp.asarray, coarse.host_scale))
    ff, cf = np.asarray(fine.free), np.asarray(coarse.free)
    assert _rel(mg._jit_restrict_hat64(fs, cs, t(cf), t(r), 3),
                ref_mg._jit_restrict_hat64(ref_fs, ref_cs, jnp.asarray(cf),
                                           jnp.asarray(r), 3)) <= 1e-12
    assert _rel(mg._jit_prolong_hat64(fs, cs, t(ff), t(e), 3),
                ref_mg._jit_prolong_hat64(ref_fs, ref_cs, jnp.asarray(ff),
                                          jnp.asarray(e), 3)) <= 1e-12
    # R̂ = P̂ᵀ on the free DOFs
    e, r = e * cf, r * ff
    lhs = float((mg._prolong_hat(pf, pc, t(e), 3, 3).numpy() * r).sum())
    rhs = float((e * mg._restrict_hat(pf, pc, t(r), 3, 3).numpy()).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def _carry(h_ref):
    levels = []
    for lv in h_ref.levels:
        C, Cinv = lv.host_scale
        levels.append(dict(offsets=lv.offsets, weights=lv.host_weights,
                           free=np.asarray(lv.free), omega=lv.omega,
                           C=C, Cinv=Cinv, host_Ainv=lv.host_Ainv))
    return convert.hierarchy_from_numpy(
        levels, h_ref.grid_dim, h_ref.vdim, h_ref.pre_smooth,
        h_ref.post_smooth, h_ref.coarse_iters, device="cpu")


def test_v_cycle_matches_reference_on_carried_hierarchy(monkeypatch):
    # the reference's kernel route (Pallas interpret, bf16 smoother weights)
    # is the port's route at every level: both size gates lowered
    monkeypatch.setenv("PDE_TPU_PALLAS", "1")
    monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_DOF", 100)
    monkeypatch.setattr(mg, "BF16_MIN_DOF", 100)
    mesh, sysm, builder = _cantilever((8, 4, 4))
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32)
    assert isinstance(h_ref.levels[0].w_lo, pallas_kernels.FlatStencilOperator)
    h = _carry(h_ref)
    assert [lv.omega for lv in h.levels] == [lv.omega for lv in h_ref.levels]
    assert isinstance(h.levels[0].w_lo, sk.FlatStencilOperator)
    assert h.levels[0].w_lo.W.dtype == torch.bfloat16
    r = np.random.default_rng(2).standard_normal(
        sysm.b_hat.shape).astype(np.float32)
    z_ref = np.asarray(ref_mg.v_cycle(h_ref, jnp.asarray(r)))
    z = mg.v_cycle(h, torch.from_numpy(r))
    assert _rel(z, z_ref) <= 1e-5  # f32, sums in another order


def test_mg_pcg_converges_on_carried_hierarchy():
    mesh, sysm, builder = _cantilever((8, 4, 4))
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32)
    h = _carry(h_ref)
    b = torch.from_numpy(sysm.b_hat.astype(np.float32))
    x, k, relres = mg.mg_pcg(h, b, torch.zeros_like(b), 1e-5, 200)
    assert relres <= 1e-5 and 0 < k <= 60, (k, relres)
    xr, kr, rr = ref_mg.mg_pcg(h_ref, jnp.asarray(sysm.b_hat, jnp.float32),
                               jnp.zeros(sysm.b_hat.shape, jnp.float32),
                               1e-5, 200)
    assert abs(k - int(kr)) <= max(1, int(0.1 * int(kr)))
    assert _rel(x, xr) <= 1e-4  # both solved to 1e-5 relres


def test_fcycle_df2_matches_reference_iterations():
    mesh, sysm, builder = _cantilever()
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32)
    lad_ref = ref_mg.build_df_ladder(h_ref, sysm, sysm.b_hat)
    _, _, it_ref, rr_ref = ref_mg.solve_fcycle_df2(h_ref, lad_ref, 1e-9)

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, device="cpu")
    assert len(h.levels) == len(h_ref.levels) == 3
    lad = mg.build_df_ladder(h, sysm, sysm.b_hat)
    x_hi, x_lo, it, rr = mg.solve_fcycle_df2(h, lad, 1e-9)
    assert rr_ref <= 1e-9 and rr <= 1e-9, (rr_ref, rr)
    assert abs(it - it_ref) <= 0.1 * it_ref, (it, it_ref)
    # the port's own ω agrees with the reference's to f32 power-iteration
    # roundoff
    for lv, lr in zip(h.levels, h_ref.levels):
        assert abs(lv.omega - lr.omega) <= 1e-5 * lr.omega


# ---- the 2D plate (vdim=2, K1/K2 v2 on the card) ----------------------------

def test_hat_transfers_2d_match_reference_f64():
    mesh, sysm, builder = _cantilever((16, 8))
    h = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=2,
                               dtype=jnp.float64)
    fine, coarse = h.levels[0], h.levels[1]

    def t(a):
        return torch.from_numpy(np.array(a))

    def port_level(lv):
        C, Cinv = lv.host_scale
        return mg.MGLevel(lv.offsets, None, t(np.asarray(lv.free)), 1.0,
                          None, t(C), t(Cinv))

    pf, pc = port_level(fine), port_level(coarse)
    rng = np.random.default_rng(1)
    r = rng.standard_normal(np.asarray(fine.free).shape)
    e = rng.standard_normal(np.asarray(coarse.free).shape)
    assert _rel(mg._restrict_hat(pf, pc, t(r), 2, 2),
                ref_mg._restrict_hat(fine, coarse, jnp.asarray(r), 2, 2)) <= 1e-12
    assert _rel(mg._prolong_hat(pf, pc, t(e), 2, 2),
                ref_mg._prolong_hat(fine, coarse, jnp.asarray(e), 2, 2)) <= 1e-12


def test_v_cycle_2d_matches_reference_on_carried_hierarchy(monkeypatch):
    """One V-cycle on the plate with every level on the kernel route (bf16
    smoother weights) in both packages: both bf16 gates lowered to 1 DOF.
    With one package's coarse level smoothing with f32 weights and the
    other's with bf16, the two V-cycles differ by ~1.4e-3, the size of the
    bf16 smoothing itself."""
    monkeypatch.setenv("PDE_TPU_PALLAS", "1")
    monkeypatch.setattr(pallas_kernels, "PALLAS_MIN_DOF", 1)
    monkeypatch.setattr(mg, "BF16_MIN_DOF", 1)
    mesh, sysm, builder = _cantilever((16, 8))
    h_ref = ref_mg.build_hierarchy(mesh, sysm, builder, vdim=2,
                                   dtype=jnp.float32)
    assert all(isinstance(lv.w_lo, pallas_kernels.FlatStencilOperator)
               for lv in h_ref.levels)
    h = _carry(h_ref)
    assert h.grid_dim == 2 and h.vdim == 2
    assert [lv.omega for lv in h.levels] == [lv.omega for lv in h_ref.levels]
    r = np.random.default_rng(2).standard_normal(
        sysm.b_hat.shape).astype(np.float32)
    z_ref = np.asarray(ref_mg.v_cycle(h_ref, jnp.asarray(r)))
    z = mg.v_cycle(h, torch.from_numpy(r))
    assert _rel(z, z_ref) <= 1e-5  # f32, sums in another order
    b = torch.from_numpy(sysm.b_hat.astype(np.float32))
    x, k, relres = mg.mg_pcg(h, b, torch.zeros_like(b), 1e-5, 200)
    xr, kr, rr = ref_mg.mg_pcg(h_ref, jnp.asarray(sysm.b_hat, jnp.float32),
                               jnp.zeros(sysm.b_hat.shape, jnp.float32),
                               1e-5, 200)
    assert relres <= 1e-5 and abs(k - int(kr)) <= max(1, int(0.1 * int(kr)))
    assert _rel(x, xr) <= 1e-4  # both solved to 1e-5 relres
