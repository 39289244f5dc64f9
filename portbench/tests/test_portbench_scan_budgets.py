"""The heat cell's ``past_iters_per_step.heat`` and ``scan_reruns.heat``:
the masked iterations the step programs run past their step's
convergence over the window's steps, and the mean chunks a window request
runs again step by step, read from the program's ``scan_past_iterations``
and ``scan_reruns`` counters in each request's ``solver_stats``.  The
readers' arithmetic on a made-up run, nothing read where the counter is
missing (as a program without it gives), and a tiny heat cell on the CPU
whose traced run reports both."""

import pytest

from portbench.lib import harness
from portbench.lib.harness import Run
from portbench.lib.spec import Benchmark
from portbench.tests import tiny

CELL = "heat3d-128.followup"
KEY = {"past_iters_per_step.heat": "scan_past_iterations",
       "scan_reruns.heat": "scan_reruns"}
# two window requests of 200 and 100 steps, and a failed one, left out
STATS = [{"scan_past_iterations": 500, "scan_reruns": 0},
         {"scan_past_iterations": 250, "scan_reruns": 1}]
UNITS = [200, 100]
EXPECTED = {"past_iters_per_step.heat": 750 / 300, "scan_reruns.heat": 0.5}


def _run(stats, units=UNITS):
    recs = [{"ok": True, "stats": dict(s), "units": u}
            for s, u in zip(stats, units)]
    recs.append({"ok": False, "units": 50,
                 "stats": {k: 10 ** 6 for k in KEY.values()}})
    return Run(cell=None, seed=1, seconds=1.0, records=recs)


@pytest.mark.parametrize("name", sorted(KEY))
def test_reader_reads_the_window(name):
    reader = Benchmark(tiny.REPO).metric_reader(name)
    assert reader.read(_run(STATS)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(KEY))
def test_reader_finds_nothing_without_its_counter(name):
    reader = Benchmark(tiny.REPO).metric_reader(name)
    bare = [{k: v for k, v in s.items() if k != KEY[name]} for s in STATS]
    assert reader.read(_run(bare)) is None
    assert reader.read(_run([], [])) is None


@pytest.mark.parametrize("name", sorted(KEY))
def test_metric_is_the_heat_cells_and_moves_its_wait(name):
    spec = Benchmark(tiny.REPO).spec
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "static_solve_s"
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "scan and static solve"


def test_tiny_heat_cell_reports_both(tmp_path):
    """The tiny heat cell (8³, 10 steps): both counters reach their
    readers through each window request's ``solver_stats``; its window
    requests run on the programs the warm-up captured, and none reruns."""
    root = tiny.make_root(str(tmp_path))
    out = harness.run_cell(root, CELL, 2718281828, 0.5, True, device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["scan_reruns.heat"]["value"] == 0.0
    assert out["metrics"]["past_iters_per_step.heat"]["value"] >= 0.0
