"""θ-steps stopped on their free rows.

A step's right side carries the Dirichlet values g on its constrained rows.
With faces at tens of degrees those fill its norm, and a float32 step
stopped at ``transient_inner_tol`` of that norm does next to no work: its
frames drift from the float64 answer.  The port's steps solve on the free
rows alone and put g back after.  On a 16³ box with faces at 90, 10 and
60 °C over a start at 20 °C, MG-PCG step solves and the default
``transient_inner_tol``, the "mixed" frames (a float32 scan on the CPU)
lie within 1e-4 of the port's float64 path and of the benchmark's plain
float64 θ-scheme (``portbench/reference/heat_theta.py``), where a step
stopped on the whole norm lies ~9e-4 off; every step iterates while the
field moves, and the Dirichlet rows hold g exactly.  So do the
step-program, per-step and checkpointed paths of ``run_transient``, and
the sharded θ-scan on four virtual devices (12³, CG step solves, where
the whole norm gives ~4e-4)."""

import numpy as np
import pytest

from pde_solver_tpu_torch import api, config
from pde_solver_tpu_torch.fields import load_field
from pde_solver_tpu_torch.ops import device_loop
from pde_solver_tpu_torch.utils import kept
from portbench.reference import heat_theta

STEPS = 40
REQ = dict(T_left=90.0, T_right=10.0, T_side=60.0, T_initial=20.0)
MG = dict(transient_mg_threshold=100, mg_threshold=100)
GAP = 1e-4


@pytest.fixture(autouse=True)
def _cold_scans():
    kept.clear_all()
    yield
    kept.clear_all()


def _record_steps(monkeypatch):
    """The iterations of each step the scans run after this call."""
    seen = []
    run_scan = device_loop.run_scan

    def spy(store, key, step, *rest, **kw):
        def recorded(c, n, solve):
            out = step(c, n, solve)
            seen.append(int(out[1]))
            return out
        return run_scan(store, key, recorded, *rest, **kw)

    monkeypatch.setattr(device_loop, "run_scan", spy)
    return seen


def _heat(n, tmp_path, **cfg):
    """``solve_heat_3D`` on the n³ unit box: (frames [t, N] float64,
    solver_stats)."""
    with config.config_overrides(device="cpu", **cfg):
        res = api.solve_heat_3D(Lx=1.0, Ly=1.0, Lz=1.0, nx=n, ny=n, nz=n,
                                dt=0.01, num_steps=STEPS,
                                data_dir=str(tmp_path), **REQ)
    field = load_field(res.data_file)
    return (np.asarray(field.values_array(), np.float64),
            res.meta["solver_stats"])


def _reference(n):
    """The plain float64 θ-scheme's frames (every step kept)."""
    cfg = {"mesh": {"cells": [n] * 3, "extent": [1.0] * 3},
           "tool_args": {"dt": 0.01, "num_steps": STEPS, "diffusivity": 1.0},
           "config_overrides": {"snapshot_max_frames": 0}, "theta": 1.0}
    return heat_theta.trajectory(cfg, REQ, "cpu")["values"]


def _dirichlet(n):
    """(mask, values) of the box's Dirichlet nodes in the tools' flat node
    order (x fastest): T_left on x = 0, T_right on x = 1, T_side on the
    other faces less those two."""
    idx = np.indices((n + 1,) * 3)        # (z, y, x) in flat order
    z, y, x = idx[0].ravel(), idx[1].ravel(), idx[2].ravel()
    side = (y == 0) | (y == n) | (z == 0) | (z == n)
    mask = (x == 0) | (x == n) | side
    g = np.where(x == 0, REQ["T_left"],
                 np.where(x == n, REQ["T_right"], REQ["T_side"]))
    return mask, g


def _hold(v, stats, seen, v64, ref, n):
    """Within GAP of the float64 path and of the reference, every step
    iterating, the Dirichlet rows at g exactly."""
    scale = np.abs(ref).max()
    assert v.shape == ref.shape == v64.shape
    assert np.abs(v - v64).max() / scale <= GAP
    assert np.abs(v - ref).max() / scale <= GAP
    assert stats["converged"] and len(seen) == STEPS
    assert min(seen) >= 1 and stats["cg_iterations"] == sum(seen)
    mask, g = _dirichlet(n)
    assert np.array_equal(v[:, mask], np.broadcast_to(g[mask],
                                                      v[:, mask].shape))


@pytest.fixture(scope="module")
def float64_16(tmp_path_factory):
    """The port's float64 path and the reference on the 16³ box."""
    v64, _ = _heat(16, tmp_path_factory.mktemp("f64"), precision="f64",
                   **MG)
    return v64, _reference(16)


@pytest.mark.parametrize("path", ["step programs", "per step",
                                  "checkpointed"])
def test_mixed_frames_hold_float64(path, float64_16, tmp_path,
                                   monkeypatch):
    v64, ref = float64_16
    seen = _record_steps(monkeypatch)
    cfg = dict(precision="mixed", **MG)
    if path == "checkpointed":
        cfg.update(transient_checkpoint_every=8,
                   checkpoint_dir=str(tmp_path / "ck"))
    if path == "per step":
        with device_loop._per_step():
            v, stats = _heat(16, tmp_path, **cfg)
    else:
        v, stats = _heat(16, tmp_path, **cfg)
    _hold(v, stats, seen, v64, ref, 16)
    if path != "per step":
        assert stats["scan_stepwise_chunks"] >= 1 and stats["scan_reruns"] == 0


def test_sharded_mixed_frames_hold_float64(tmp_path, monkeypatch):
    """The sharded θ-scan (4 virtual shards, CG step solves) at 12³."""
    monkeypatch.setenv("PDE_TPU_VIRTUAL_DEVICES", "4")
    v64, _ = _heat(12, tmp_path / "f64", precision="f64")
    seen = _record_steps(monkeypatch)
    v, stats = _heat(12, tmp_path, precision="mixed", shard_devices=4)
    _hold(v, stats, seen, v64, _reference(12), 12)
