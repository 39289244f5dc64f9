"""Checkpointed transient and Newmark scans of the port: the cases of the
JAX package's ``tests/test_checkpoint.py`` run against the port (float64,
the CPU's "auto"), each interrupted run resuming bitwise; the port names a
case's checkpoint file as the JAX package does; and a port checkpointed
run against the JAX package's uncheckpointed one (≤ 1e-9)."""

import os

import numpy as np
import pytest

from pde_solver_tpu import config as ref_config
from pde_solver_tpu import mesh as ref_mesh
from pde_solver_tpu.ops import assembly as ref_asm
from pde_solver_tpu.ops import timestepping as ref_ts
from pde_solver_tpu.ops.bc import DirichletBC as RefBC
from pde_solver_tpu_torch.config import config_overrides
from pde_solver_tpu_torch.mesh import interval_mesh, rectangle_mesh
from pde_solver_tpu_torch.ops import assembly, timestepping
from pde_solver_tpu_torch.ops.bc import DirichletBC, all_boundary
from pde_solver_tpu_torch.ops.timestepping import run_newmark, run_transient


@pytest.fixture(autouse=True)
def _cpu():
    with config_overrides(device="cpu"):
        yield


def _ckpt(tmp_path, every=4, **kw):
    return config_overrides(transient_checkpoint_every=every,
                            checkpoint_dir=str(tmp_path), **kw)


def _npz(tmp_path):
    return [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


def _problem():
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(20.0 * np.ones(mesh.node_shape)))
    return mesh, K, M, bc, b, u0


def test_checkpointed_run_matches_plain(tmp_path):
    mesh, K, M, bc, b, u0 = _problem()
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=10)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=10)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert ck.total_cg_iterations == ref.total_cg_iterations
    assert not os.listdir(tmp_path)  # checkpoint removed on completion


def test_interrupted_run_resumes(tmp_path, monkeypatch):
    mesh, K, M, bc, b, u0 = _problem()
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    files = _npz(tmp_path)            # one chunk of 4 steps persisted
    assert len(files) == 1
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
        assert z["carry"].dtype == np.float64   # the carry at full precision
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert not _npz(tmp_path)


def test_checkpoint_key_covers_boundary_values(tmp_path, monkeypatch):
    """A checkpoint from T_boundary=5 is not resumed by a run with
    T_boundary=7 (the content key covers the lift and the BC data)."""
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    b = assembly.assemble_load(mesh)
    u0 = np.zeros(mesh.node_shape)
    bc5, bc7 = (DirichletBC.from_masks([(all_boundary(mesh), v)],
                                       mesh.node_shape) for v in (5.0, 7.0))
    ref7 = run_transient(K, M, mesh, bc7, b, u0, dt=0.01, num_steps=8)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc5, b, u0, dt=0.01, num_steps=8)
    assert _npz(tmp_path)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck7 = run_transient(K, M, mesh, bc7, b, u0, dt=0.01, num_steps=8)
    np.testing.assert_array_equal(ck7.values, ref7.values)


def test_resume_with_shorter_target_is_consistent(tmp_path, monkeypatch):
    """A checkpoint ahead of a shorter re-request is discarded: the result
    matches the fresh short run, values and times alike."""
    mesh, K, M, bc, b, u0 = _problem()
    ref2 = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=2)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck2 = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=2)
    assert ck2.values.shape[0] == ck2.times.shape[0] == 3
    np.testing.assert_array_equal(ck2.values, ref2.values)
    np.testing.assert_array_equal(ck2.times, ref2.times)


def test_unreadable_checkpoint_is_recomputed_over(tmp_path, monkeypatch):
    """A file under the case's name that is not a readable npz is
    recomputed over from step 0, and removed on completion."""
    mesh, K, M, bc, b, u0 = _problem()
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=8)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=8)
    (name,) = _npz(tmp_path)
    (tmp_path / name).write_bytes(b"not an npz")
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=8)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert not _npz(tmp_path)


def test_checkpointed_run_applies_snapshot_thinning(tmp_path):
    """The checkpointed path thins frames as the plain path does."""
    mesh, K, M, bc, b, u0 = _problem()
    with config_overrides(snapshot_max_frames=5):
        ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=20)
    with _ckpt(tmp_path, every=8, snapshot_max_frames=5):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=20)
    assert ck.values.shape[0] == ref.values.shape[0] <= 7
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.times, ref.times)


# ----------------------------------------------------------------------
# Newmark (elastodynamics / wave)
# ----------------------------------------------------------------------

def _newmark_problem(m=None):
    m = m or (rectangle_mesh, assembly, DirichletBC, all_boundary)
    mk_mesh, asm, BC, boundary = m
    mesh = mk_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = {o: 4.0 * W for o, W in asm.assemble_scalar_stencil(
        mesh, "stiffness").items()}                   # c² = 4
    M = asm.assemble_scalar_stencil(mesh, "mass")
    bc = BC.from_masks([(boundary(mesh), 0.0)], mesh.node_shape)
    x, y = np.meshgrid(mesh.axis_nodes(0), mesh.axis_nodes(1), indexing="ij")
    u0 = np.sin(np.pi * x) * np.sin(np.pi * y)
    return mesh, K, M, bc, np.zeros_like(u0), u0, np.zeros_like(u0)


def test_newmark_checkpointed_run_matches_plain(tmp_path):
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=10)
    with _ckpt(tmp_path):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=10)
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.velocities, ref.velocities)
    assert ck.total_cg_iterations == ref.total_cg_iterations
    assert not os.listdir(tmp_path)


def test_newmark_interrupted_run_resumes_bitwise(tmp_path, monkeypatch):
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    files = _npz(tmp_path)
    assert len(files) == 1 and files[0].startswith("newmark-")
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
        assert z["us"].shape[0] == 4              # 4 persisted frames
        assert {"u", "v", "a"} <= set(z.files)    # the whole carry
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.velocities, ref.velocities)
    assert not _npz(tmp_path)


def test_newmark_checkpoint_longer_target_continues(tmp_path, monkeypatch):
    """num_steps is not in the content key: a longer request resumes the
    chunks of a shorter, killed run."""
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError):
            run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=6)
    assert len(_npz(tmp_path)) == 1     # 4 of the 6 steps persisted
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    with _ckpt(tmp_path):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    np.testing.assert_array_equal(ck.values, ref.values)


def test_wave_model_checkpoint_roundtrip(tmp_path):
    """The wave family inherits Newmark checkpointing through run_newmark."""
    from pde_solver_tpu_torch.models.wave import (WaveProblem,
                                                  solve_wave_problem)

    p = WaveProblem(mesh=interval_mesh(24, 0.0, 1.0), wave_speed=2.0,
                    initial_type="sine", initial_wavenumber=np.pi, dt=0.004,
                    num_steps=9)
    _, ref, _ = solve_wave_problem(p)
    with _ckpt(tmp_path):
        _, ck, _ = solve_wave_problem(p)
    np.testing.assert_array_equal(ck, ref)


def _convection_problem(u0_fn):
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = {o: 0.05 * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    C = assembly.assemble_convection_stencil(mesh, [0.8, -0.3])
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(u0_fn(mesh)))
    return mesh, K, M, C, bc, b, u0


def test_cnab2_interrupted_run_resumes_bitwise(tmp_path, monkeypatch):
    """CNAB2's AB2 history (u_prev) persists in the checkpoint, so an
    interrupted run resumes with the exact convection extrapolation."""
    mesh, K, M, C, bc, b, u0 = _convection_problem(lambda m: np.exp(
        -((m.node_coords[..., 0] - 0.4) ** 2
          + (m.node_coords[..., 1] - 0.6) ** 2) / 0.04))
    kw = dict(dt=0.005, num_steps=12, theta=0.5, C_np=C,
              convection_scheme="cnab2")
    ref = run_transient(K, M, mesh, bc, b, u0, **kw)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, **kw)
    files = _npz(tmp_path)
    assert len(files) == 1
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
        assert "u_prev" in z.files           # the AB2 history
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, **kw)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert not _npz(tmp_path)


def test_cnab2_checkpoint_key_distinct_from_ab1(tmp_path, monkeypatch):
    """An AB1 run's checkpoint never seeds a CNAB2 run of the same
    problem: the content keys differ."""
    mesh, K, M, C, bc, b, u0 = _convection_problem(
        lambda m: np.ones(m.node_shape))
    kw = dict(dt=0.005, num_steps=12, theta=0.5, C_np=C)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, convection_scheme="ab1",
                          **kw)
    names_ab1 = set(os.listdir(tmp_path))
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, convection_scheme="cnab2",
                           **kw)
    ref = run_transient(K, M, mesh, bc, b, u0, convection_scheme="cnab2",
                        **kw)
    assert names_ab1 <= set(os.listdir(tmp_path))   # not consumed
    np.testing.assert_array_equal(ck.values, ref.values)


# ----------------------------------------------------------------------
# Against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scan", ["transient", "newmark"])
def test_checkpoint_file_named_as_the_reference_names_it(scan, tmp_path,
                                                         monkeypatch):
    """Both packages hash the same float64 host arrays into the content
    key, so an interrupted run of one case leaves a file of one name."""
    names = {}
    for pkg, ts, cfg in (("ref", ref_ts, ref_config), ("port", timestepping,
                                                       None)):
        out = tmp_path / pkg
        monkeypatch.setattr(ts, "_CKPT_TEST_ABORT", 1)
        if pkg == "ref":
            mods = (ref_mesh.rectangle_mesh, ref_asm, RefBC,
                    lambda m: m.boundary_mask())
            ctx = cfg.config_overrides(transient_checkpoint_every=4,
                                       checkpoint_dir=str(out))
        else:
            mods = None
            ctx = _ckpt(out)
        mesh, K, M, bc, f, u0, v0 = _newmark_problem(mods)
        with ctx, pytest.raises(RuntimeError, match="checkpoint test abort"):
            if scan == "transient":
                ts.run_transient(K, M, mesh, bc, f, u0, dt=0.01,
                                 num_steps=12)
            else:
                ts.run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005,
                               num_steps=12)
        names[pkg] = os.listdir(out)
    assert names["port"] == names["ref"] and len(names["ref"]) == 1


def test_checkpointed_run_matches_reference_uncheckpointed(tmp_path,
                                                           monkeypatch):
    """A port run interrupted and resumed against the JAX package's
    uncheckpointed float64 run of the same case: frames within 1e-9."""
    mesh, K, M, C, bc, b, u0 = _convection_problem(lambda m: np.exp(
        -((m.node_coords[..., 0] - 0.4) ** 2
          + (m.node_coords[..., 1] - 0.6) ** 2) / 0.04))
    kw = dict(dt=0.005, num_steps=12, theta=0.5, C_np=C,
              convection_scheme="cnab2")
    rmesh = ref_mesh.rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    ref = ref_ts.run_transient(K, M, rmesh, RefBC(bc.free_mask, bc.values),
                               b, u0, **kw)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with _ckpt(tmp_path):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, **kw)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with _ckpt(tmp_path):
        ck = run_transient(K, M, mesh, bc, b, u0, **kw)
    assert ck.values.shape == ref.values.shape
    np.testing.assert_array_equal(ck.times, ref.times)
    scale = np.abs(ref.values).max()
    assert np.abs(ck.values - ref.values).max() <= 1e-9 * scale
