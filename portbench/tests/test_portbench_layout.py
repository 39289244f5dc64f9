"""The harness finds a cell's configuration, mix, workload file, driver
and metrics by name: a throwaway configuration, mix, metric and cell,
dropped in as new files and entries, run without an edit to any file the
benchmark has."""

import json
import os

from portbench.lib import harness
from portbench.tests import tiny


def test_drop_in_cell_runs(tmp_path):
    root = tiny.make_root(str(tmp_path))
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "configs", "heat3d-128.json")) as f:
        cfg = json.load(f)
    cfg["mesh"] = {"cells": [6, 4, 4], "extent": [2.0, 1.0, 1.0]}
    cfg["tool_args"].update(Lx=2.0, nx=6, ny=4, nz=4, num_steps=6)
    with open(os.path.join(base, "configs", "slab-tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "traffic", "hot-left.json"), "w") as f:
        json.dump({"warmup": [{"T_left": 80.0, "T_right": 0.0,
                               "T_side": 0.0, "T_initial": 0.0}],
                   "draw": {"T_left": {"uniform": [60.0, 100.0]},
                            "T_right": {"value": 0.0},
                            "T_side": {"value": 0.0},
                            "T_initial": {"value": 0.0}}}, f)
    with open(os.path.join(base, "workloads", "slab-tiny.hot-left.json"),
              "w") as f:
        json.dump({"limits": {"frame_gap": 1e-6}, "check_requests": 2,
                   "trace_requests": 1}, f)
    with open(os.path.join(base, "metrics", "wall_s.slab.py"), "w") as f:
        f.write("def read(run):\n"
                "    return sum(r['wall_s'] for r in run.trace_records)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = "slab-tiny.hot-left"
    spec["configs"].append({"name": "slab-tiny", "source": "test",
                            "file": "portbench/configs/slab-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "slab-tiny",
                              "traffic": "hot-left", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append(cell)
    spec["per_layer"].append({"name": "wall_s.slab", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "tool", "moves": "heat_steps_per_s",
                              "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    out = harness.run_cell(root, cell, 11, 0.5, False, device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"heat_steps_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["frame_gap"]["limit"] == 1e-6

    out = harness.run_cell(root, cell, 12, 0.5, True, device="cpu")
    assert out["correct"]
    assert out["metrics"]["wall_s.slab"]["value"] > 0
    assert "k1_roofline.heat" not in out["metrics"]   # no card, nothing read
