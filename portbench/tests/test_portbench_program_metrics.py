"""The readers of the metrics that come from inside the program (its spans'
seconds and its counters in ``solver_stats``): each reads a made-up run
as its arithmetic says, and finds nothing in a run whose requests lack
its key, as a program without those spans and counters gives."""

import pytest

from portbench.lib.harness import Run
from portbench.lib.spec import Benchmark
from portbench.tests.tiny import REPO

CELL = "cantilever3d-2M.loadcases"
GIB = 2 ** 30
# two window requests and a failed one, whose stats are left out
STATS = [
    {"assembly_stencil_seconds": 4.0, "assembly_load_seconds": 0.5,
     "hash_seconds": 0.9, "hashed_bytes": 3 * GIB // 2,
     "df2_seconds": 1.1, "df2_device_seconds": 1.0, "fetch_seconds": 0.2,
     "graphs_captured": 0, "kernel_launches": 8000, "cg_iterations": 540},
    {"assembly_stencil_seconds": 5.0, "assembly_load_seconds": 0.7,
     "hash_seconds": 1.1, "hashed_bytes": 3 * GIB // 2,
     "df2_seconds": 1.3, "df2_device_seconds": 1.2, "fetch_seconds": 0.4,
     "graphs_captured": 2, "kernel_launches": 9000, "cg_iterations": 560},
]
FAILED = {"ok": False, "stats": {k: 1e9 for k in STATS[0]}}
EXPECTED = {
    "assembly_stencil_s.static": 4.5,
    "assembly_load_s.static": 0.6,
    "hash_s.static": 1.0,
    "hashed_gib.static": 1.5,
    "df2_s.static": 1.2,
    "df2_device_s.static": 1.1,
    "fetch_s.static": 0.3,
    "graphs_captured.static": 1.0,
    "launches_per_iter.static": 17000 / 1100,
}
# what each reader needs of a request's stats
KEY = {
    "assembly_stencil_s.static": "assembly_stencil_seconds",
    "assembly_load_s.static": "assembly_load_seconds",
    "hash_s.static": "hash_seconds",
    "hashed_gib.static": "hashed_bytes",
    "df2_s.static": "df2_seconds",
    "df2_device_s.static": "df2_device_seconds",
    "fetch_s.static": "fetch_seconds",
    "graphs_captured.static": "graphs_captured",
    "launches_per_iter.static": "kernel_launches",
}


def _run(stats):
    return Run(cell=None, seed=1, seconds=1.0,
               records=[{"ok": True, "stats": dict(s)} for s in stats]
               + [FAILED])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_window(name):
    reader = Benchmark(REPO).metric_reader(name)
    assert reader.read(_run(STATS)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_its_key(name):
    reader = Benchmark(REPO).metric_reader(name)
    bare = [{k: v for k, v in s.items() if k != KEY[name]} for s in STATS]
    assert reader.read(_run(bare)) is None
    assert reader.read(_run([])) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_is_the_cells_and_moves_its_solve(name):
    spec = Benchmark(REPO).spec
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "static_solve_s"
    assert entry["better"] == "lower"
    assert entry["source"] in ("program_span", "program_counter")
    assert entry["layer"] in {m["layer"] for m in spec["per_layer"]
                              if m["name"] not in EXPECTED}
