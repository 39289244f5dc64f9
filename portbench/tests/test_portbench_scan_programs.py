"""The heat cell's ``scan_programs_built.heat``: the mean step programs a
window request builds, read from the program's ``scan_programs_built``
counter in each request's ``solver_stats``.  The reader's arithmetic on a
made-up run, nothing read where the counter is missing (as a program
without it gives), and a tiny heat cell on the CPU whose window requests,
each with new faces and a new start, run on the programs its warm-up
captured."""

import pytest

from portbench.lib import harness
from portbench.lib.harness import Run
from portbench.lib.spec import Benchmark
from portbench.tests import tiny

NAME = "scan_programs_built.heat"
CELL = "heat3d-128.followup"


def _run(values, failed=True):
    recs = [{"ok": True, "stats": {} if v is None
             else {"scan_programs_built": v}} for v in values]
    if failed:
        recs.append({"ok": False, "stats": {"scan_programs_built": 99}})
    return Run(cell=None, seed=1, seconds=1.0, records=recs)


@pytest.mark.parametrize("values, expected", [
    ([0, 0, 0], 0.0), ([2, 0, 1, 1], 1.0), ([0, None, 3], 1.5)])
def test_reader_means_the_window_requests(values, expected):
    reader = Benchmark(tiny.REPO).metric_reader(NAME)
    assert reader.read(_run(values)) == pytest.approx(expected)


def test_reader_finds_nothing_without_the_counter():
    reader = Benchmark(tiny.REPO).metric_reader(NAME)
    assert reader.read(_run([None, None])) is None
    assert reader.read(_run([], failed=False)) is None


def test_metric_is_the_heat_cells_and_moves_its_wait():
    spec = Benchmark(tiny.REPO).spec
    entry = next(m for m in spec["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "static_solve_s"
    assert entry["source"] == "program_counter"
    cell = Benchmark(tiny.REPO).cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"static_solve_s",
                                                    "setup_s"}


def test_window_requests_build_no_step_program(tmp_path):
    """The tiny heat cell (8³, 10 steps): the counter reaches the reader
    through each window request's ``solver_stats``, and reads 0."""
    root = tiny.make_root(str(tmp_path))
    out = harness.run_cell(root, CELL, 3141592653, 0.5, True, device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"][NAME]["value"] == 0.0
