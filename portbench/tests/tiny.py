"""A copy of the benchmark at sizes a CPU test run holds: the same files,
the configurations' meshes cut down, and the heat cells that
``BENCHMARK.json`` leaves out until the program holds its step tolerance
(their configuration, mixes, driver, reference and readers are kept)
dropped in as a later change would add them.  Used by the
``test_portbench_*`` files; runs the harness with ``device="cpu"`` (no
look for a card)."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HEAT_CELLS = [8, 8, 8]
BEAM_CELLS = [16, 4, 4]
HEAT = ["heat3d-128.followup", "heat3d-128.materials"]
# the CPU runs the port in float64: its frames lie ~1e-9 off the reference
HEAT_WORKLOAD = {"limits": {"frame_gap": 1e-6}, "check_requests": 1,
                 "trace_requests": 2}


def _edit(path: str, fn) -> None:
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_root(tmp: str) -> str:
    """``tmp``/root: BENCHMARK.json and portbench/ with tiny meshes."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    cfg = os.path.join(root, "portbench", "configs")

    def heat(c):
        c["mesh"]["cells"] = HEAT_CELLS
        c["tool_args"].update(nx=8, ny=8, nz=8, num_steps=10)
        c["config_overrides"]["snapshot_max_frames"] = 4

    def beam(c):
        c["mesh"]["cells"] = BEAM_CELLS
        c["tool_args"].update(nx=16, ny=4, nz=4)
        # the iterative paths, not host LU, at this size too
        c["config_overrides"]["host_direct_threshold"] = 0

    _edit(os.path.join(cfg, "heat3d-128.json"), heat)
    _edit(os.path.join(cfg, "cantilever3d-2M.json"), beam)
    _add_heat_cells(root)
    return root


def _add_heat_cells(root: str) -> None:
    for cell in HEAT:
        with open(os.path.join(root, "portbench", "workloads",
                               cell + ".json"), "w") as f:
            json.dump(HEAT_WORKLOAD, f)

    def spec(s):
        s["configs"].append({"name": "heat3d-128", "source": "test",
                             "file": "portbench/configs/heat3d-128.json",
                             "reduced": ["snapshot_max_frames"],
                             "why": "test"})
        s["workloads"] += [{"name": c, "config": "heat3d-128",
                            "traffic": c.split(".")[1], "chips": 1,
                            "why": "test"} for c in HEAT]
        s["end_to_end"].insert(0, {
            "name": "heat_steps_per_s", "unit": "steps/s",
            "better": "higher", "bound": 0.25, "source": "host_clock",
            "workloads": list(HEAT)})
        s["per_layer"] += [{
            "name": m, "unit": "s", "better": "lower",
            "source": "program_span", "layer": "test",
            "moves": "heat_steps_per_s", "workloads": list(HEAT)}
            for m in ("tool_other_s.heat", "assembly_s.heat",
                      "scan_setup_s.heat", "scan_ms_per_step.heat",
                      "iters_per_step.heat", "k1_roofline.heat",
                      "device_idle.heat", "peak_mem_gib.heat")]

    _edit(os.path.join(root, "BENCHMARK.json"), spec)
