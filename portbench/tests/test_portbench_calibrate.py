"""The readings a limit is set from, on the CPU at a tiny size: the
program's against the float64 reference, and the control's (the
reference one precision down in the program's place), which reads
further off."""

import pytest

from portbench.calibrate import calibrate, seeds
from portbench.tests import tiny


def test_seed_ranges():
    assert seeds("3-5,9") == [3, 4, 5, 9]


@pytest.mark.parametrize("cell", ["heat3d-128.followup",
                                  "cantilever3d-2M.loadcases"])
def test_control_reads_above_program(cell, tmp_path):
    root = tiny.make_root(str(tmp_path))
    rows, summary = calibrate(root, cell, [1, 2], [1], device="cpu")
    assert [r["seed"] for r in rows] == [1, 2]
    assert all(r["ok"] for r in rows)
    (key,) = [k for k in summary if k != "workload"]
    assert len(summary[key]["program"]) == 2
    assert summary[key]["upper"] > 100 * summary[key]["lower"]
