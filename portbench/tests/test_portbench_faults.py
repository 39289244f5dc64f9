"""A run of each cell with its timed path broken underneath comes out not
correct: a step that returns its state unchanged, and an answer altered
where the tool produces it.  The harness runs on the CPU at a tiny size,
without its look for a card; the faults are planted in the program for
the test alone."""

import numpy as np
import pytest

from portbench.lib import harness
from portbench.tests import tiny

CELLS = ["heat3d-128.followup", "heat3d-128.materials",
         "cantilever3d-2M.loadcases"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("faults")))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = harness.run_cell(root, cell, 2**31 + 3, 0.5, False, device="cpu")
    assert out["correct"], out["checks"]


def _altered_answer(monkeypatch):
    from pde_solver_tpu_torch import api

    real = api.save_field

    def save(field, data_dir, prefix):
        v = np.array(field.values, dtype=np.float64)
        v[-1, v.shape[1] // 2] += 0.1 * np.abs(v).max()
        field.values = v
        return real(field, data_dir, prefix)

    monkeypatch.setattr(api, "save_field", save)


def _state_unchanged_scan(monkeypatch):
    from pde_solver_tpu_torch.ops import timestepping

    real = timestepping._transient_scan

    def scan(ops, prec, u, *a, **k):
        snaps, _, u_prev, tally = real(ops, prec, u, *a, **k)
        return u.to(snaps.dtype).expand_as(snaps).clone(), u, u_prev, tally

    monkeypatch.setattr(timestepping, "_transient_scan", scan)


def _state_unchanged_solve(monkeypatch):
    from pde_solver_tpu_torch.models import elasticity

    real = elasticity.solve_stencil_system

    def solve(K, mesh, bc, b, *a, **k):
        u, stats = real(K, mesh, bc, b, *a, **k)
        return np.zeros_like(u), stats

    monkeypatch.setattr(elasticity, "solve_stencil_system", solve)


FAULTS = [(c, "altered_answer", _altered_answer) for c in CELLS] + [
    ("heat3d-128.followup", "state_unchanged", _state_unchanged_scan),
    ("heat3d-128.materials", "state_unchanged", _state_unchanged_scan),
    ("cantilever3d-2M.loadcases", "state_unchanged",
     _state_unchanged_solve)]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(root, cell, fault, plant, monkeypatch):
    plant(monkeypatch)
    out = harness.run_cell(root, cell, 2**31 + 3, 0.5, False, device="cpu")
    assert not out["correct"], out["checks"]
