"""Double-float32 arithmetic of the port: error-free transforms exact against
numpy float64, and the double-f32 stencil defect against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_solver_tpu.mesh import box_mesh
from pde_solver_tpu.ops import assembly, df32 as ref_df
from pde_solver_tpu.ops.bc import DirichletBC
from pde_solver_tpu.ops.linsolve import np_stencil_apply, prepare_system
from pde_solver_tpu_torch.ops import df32


def _f32_pairs(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n))
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n))
    return a.astype(np.float32), b.astype(np.float32)


def test_two_prod_exact_against_f64():
    a, b = _f32_pairs(0)
    p, e = df32.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert p.dtype == torch.float32 and e.dtype == torch.float32
    exact = a.astype(np.float64) * b.astype(np.float64)  # exact: 48 bits
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, exact)
    assert np.array_equal(p.numpy(), a * b)


def test_two_sum_exact_against_f64():
    a, b = _f32_pairs(1)
    # keep each sum exactly representable in f64 (exponent gap < 29)
    b = np.where(np.abs(np.log2(np.abs(a) / np.abs(b))) < 25, b, a * 0.5)
    s, e = df32.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, exact)
    s2, e2 = df32.fast_two_sum(*(torch.from_numpy(v) for v in
                                 (np.where(np.abs(a) >= np.abs(b), a, b),
                                  np.where(np.abs(a) >= np.abs(b), b, a))))
    assert np.array_equal(s2.numpy().astype(np.float64)
                          + e2.numpy().astype(np.float64), exact)


def test_df_split_and_scale_add():
    x64 = np.random.default_rng(2).standard_normal(1000) * 1e5
    hi, lo = df32.df_from_f64(x64)
    assert np.abs(df32.df_to_f64(hi, lo) - x64).max() <= 1e-14 * 1e5
    d = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    s_hi, s_lo = df32.df_scale_add(torch.from_numpy(hi), torch.from_numpy(lo),
                                   torch.tensor(0.5), torch.from_numpy(d))
    r_hi, r_lo = ref_df.df_scale_add(jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.float32(0.5), jnp.asarray(d))
    want = x64 + 0.5 * d.astype(np.float64)
    got = df32.df_to_f64(s_hi.numpy(), s_lo.numpy())
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert np.abs(got - df32.df_to_f64(np.asarray(r_hi), np.asarray(r_lo))
                  ).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("vdim", [1, 3])
def test_df_stencil_residual_matches_reference(vdim):
    mesh = box_mesh(10, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape)
        rhs = assembly.assemble_load(mesh)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.21e11, 8.08e10)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        rhs = assembly.assemble_vector_load(mesh, np.array([0, 0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, rhs, vdim)
    rng = np.random.default_rng(4)
    x64 = rng.standard_normal(sysm.b_hat.shape)
    # b close to A x: the defect cancels ~7 digits, the case df32 exists for
    b64 = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)), x64,
                           mesh.dim, vdim) * (1 + 1e-7 * rng.standard_normal(
                               x64.shape))
    xh, xl = df32.df_from_f64(x64)
    bh, bl = df32.df_from_f64(b64)
    his, los = zip(*(df32.df_from_f64(W) for W in sysm.weights))

    r_ref, rn_ref = ref_df.df_stencil_residual(
        sysm.offsets, tuple(map(jnp.asarray, his)), tuple(map(jnp.asarray, los)),
        jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(xh), jnp.asarray(xl),
        mesh.dim, vdim)
    Whi, Wlo = df32.pack_df_weights(sysm.weights, "cpu")
    r, rn = df32.jit_df_residual(
        sysm.offsets, Whi, Wlo, torch.from_numpy(bh), torch.from_numpy(bl),
        torch.from_numpy(xh), torch.from_numpy(xl), mesh.dim, vdim)
    assert r.dtype == torch.float32
    scale = np.abs(np.asarray(r_ref)).max()
    assert np.abs(r.numpy() - np.asarray(r_ref)).max() <= 1e-6 * scale
    assert abs(float(rn) - float(rn_ref)) <= 1e-5 * float(rn_ref)
    # and the defect itself is f64-grade: against the exact f64 residual
    r64 = b64 - np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)), x64,
                                 mesh.dim, vdim)
    assert np.abs(r.numpy() - r64).max() <= 1e-5 * np.abs(r64).max()
