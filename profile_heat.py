#!/usr/bin/env python3
"""Where the heat slice's scan spends its time, on one GPU.

    python3 profile_heat.py [--n 128] [--steps 20]

Runs ``api.solve_heat_3D(nx=ny=nz=n, num_steps=steps)`` (every other
argument at its default) of the PyTorch/CUDA port four times unprofiled,
with ``PDE_TPU_CS`` 0, 1, 0, 1, and prints each run's setup, scan and fetch
seconds.  Then it runs each route once under ``torch.profiler`` (CPU and
CUDA), with every step solve marked by ``record_function("step_solve")``,
and prints the device time of the kernels that started within the step
solves, summed per kernel, and that total as a share of the unprofiled
scans.  The per-kernel table goes to ``build/profile_heat.json`` as well.
Needs a CUDA card; writes only under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

MARK = "step_solve"


def solve(api, config_overrides, cs: str, n: int, steps: int, data_dir: str):
    os.environ["PDE_TPU_CS"] = cs
    with config_overrides(device="cuda"):
        res = api.solve_heat_3D(nx=n, ny=n, nz=n, num_steps=steps,
                                data_dir=data_dir)
    os.remove(res.data_file)
    return res.meta["solver_stats"]


def kernel_table(prof):
    """Device kernels that started within the marked step solves:
    {name: [ms, launches]}, and the marked span in ms."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e for e in events
             if e.name == MARK and e.device_type == DeviceType.CPU]
    lo = min(e.time_range.start for e in marks)
    hi = max(e.time_range.end for e in marks)
    table = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == MARK:
            continue
        if lo <= e.time_range.start <= hi:
            row = table.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return table, (hi - lo) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_heat: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "build")
    os.environ.setdefault("PDE_TPU_CACHE_DIR",
                          os.path.join(build, "profile_heat_cache"))
    from torch.profiler import ProfilerActivity, profile, record_function

    from pde_solver_tpu_torch import api
    from pde_solver_tpu_torch.config import config_overrides
    from pde_solver_tpu_torch.ops import multigrid as mg

    data_dir = os.path.join(build, "profile_heat")
    scans = {"0": [], "1": []}
    for cs in "0101":
        t = time.perf_counter()
        st = solve(api, config_overrides, cs, args.n, args.steps, data_dir)
        wall = time.perf_counter() - t
        scans[cs].append(st["scan_seconds"])
        print(f"PDE_TPU_CS={cs} unprofiled: scan {st['scan_seconds']:.4f} s "
              f"setup {st['setup_seconds']:.4f} s fetch "
              f"{st['fetch_seconds']:.4f} s wall {wall:.3f} s iterations "
              f"{st['cg_iterations']}", flush=True)

    orig = mg.mg_pcg

    def marked(*a, **kw):
        with record_function(MARK):
            return orig(*a, **kw)

    mg.mg_pcg = marked
    out = {"n": args.n, "steps": args.steps, "unprofiled_scan_s": scans,
           "routes": {}}
    for cs in "01":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(api, config_overrides, cs, args.n, args.steps, data_dir)
        table, span_ms = kernel_table(prof)
        total = sum(ms for ms, _ in table.values())
        launches = sum(k for _, k in table.values())
        share = ", ".join(f"{total / 1e3 / s:.3f}" for s in scans[cs])
        print(f"PDE_TPU_CS={cs} profiled: step solves span {span_ms:.2f} ms; "
              f"device kernels {total:.2f} ms in {launches} launches; "
              f"share of the unprofiled scans: {share}", flush=True)
        for name, (ms, k) in sorted(table.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:10.3f} ms {k:7d}  {name[:90]}")
        out["routes"][cs] = {"span_ms": span_ms, "kernel_ms": total,
                             "launches": launches, "kernels": table}
    mg.mg_pcg = orig
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "profile_heat.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
