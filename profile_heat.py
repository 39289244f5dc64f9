#!/usr/bin/env python3
"""Where the heat slice's scan spends its time, on one GPU.

    python3 profile_heat.py [--n 128] [--steps 20]

Runs ``api.solve_heat_3D(nx=ny=nz=n, num_steps=steps)`` (every other
argument at its default) of the PyTorch/CUDA port four times unprofiled,
with ``PDE_TPU_CS`` 0, 1, 0, 1, and prints each run's setup, scan and fetch
seconds.  Then it runs each route once under ``torch.profiler`` (CPU and
CUDA), with the scan (``timestepping._transient_scan``: its step programs
and reads) marked by ``record_function("scan")``, and prints the device
time of the kernels that started within the scan, summed per kernel, and
that total as a share of the unprofiled scans.  Every device copy of at
least 1 ms in that span is kept out of those sums and listed with its
start after the scan began, whether it started within a marked scan, and
the port's Python frames of the CPU operator that was running when it
started.  The per-kernel table goes to ``build/profile_heat.json``
as well.
Needs a CUDA card; writes only under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

MARK = "scan"


def solve(api, config_overrides, cs: str, n: int, steps: int, data_dir: str):
    os.environ["PDE_TPU_CS"] = cs
    with config_overrides(device="cuda"):
        res = api.solve_heat_3D(nx=n, ny=n, nz=n, num_steps=steps,
                                data_dir=data_dir)
    os.remove(res.data_file)
    return res.meta["solver_stats"]


def kernel_table(prof, min_copy_ms: float = 1.0):
    """Device kernels that started within the marked scans:
    {name: [ms, launches]}, and the marked span in ms.  Copies of at least
    ``min_copy_ms`` are left out (``long_copies`` lists them): the one such
    copy is the trajectory's fetch after the last step, whose start on the
    device's clock can read a few ms before the last mark's end on the
    host's."""
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
        if "Memcpy" in e.name and \
                e.time_range.elapsed_us() / 1e3 >= min_copy_ms:
            continue
        if lo <= e.time_range.start <= hi:
            row = table.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    return table, (hi - lo) / 1e3


def long_copies(prof, min_ms: float = 1.0):
    """Device copies of at least ``min_ms`` that started within the span of
    the marked scans: (name, ms, start after the span began in ms,
    inside a scan?, the package's frames of the innermost CPU operator
    with a Python stack that was running when the copy started)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    marks = [e for e in cpu if e.name == MARK]
    lo = min(e.time_range.start for e in marks)
    hi = max(e.time_range.end for e in marks)
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or "Memcpy" not in e.name:
            continue
        t, ms = e.time_range.start, e.time_range.elapsed_us() / 1e3
        if not lo <= t <= hi or ms < min_ms:
            continue
        inside = any(m.time_range.start <= t <= m.time_range.end
                     for m in marks)
        over = [c for c in cpu if c.time_range.start <= t <= c.time_range.end
                and c.stack]
        frames = []
        if over:
            op = min(over, key=lambda c: c.time_range.elapsed_us())
            frames = [f"{op.name}"] + [f for f in op.stack
                                       if "pde_solver_tpu_torch" in f][:4]
        out.append((e.name, ms, (t - lo) / 1e3, inside, frames))
    return out


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
    from pde_solver_tpu_torch.ops import timestepping

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

    orig = timestepping._transient_scan

    def marked(*a, **kw):
        with record_function(MARK):
            return orig(*a, **kw)

    timestepping._transient_scan = marked
    out = {"n": args.n, "steps": args.steps, "unprofiled_scan_s": scans,
           "routes": {}}
    for cs in "01":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            solve(api, config_overrides, cs, args.n, args.steps, data_dir)
        table, span_ms = kernel_table(prof)
        total = sum(ms for ms, _ in table.values())
        launches = sum(k for _, k in table.values())
        share = ", ".join(f"{total / 1e3 / s:.3f}" for s in scans[cs])
        print(f"PDE_TPU_CS={cs} profiled: scan span {span_ms:.2f} ms; "
              f"device kernels {total:.2f} ms in {launches} launches; "
              f"share of the unprofiled scans: {share}", flush=True)
        for name, (ms, k) in sorted(table.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:10.3f} ms {k:7d}  {name[:90]}")
        copies = long_copies(prof)
        for name, ms, at, inside, frames in copies:
            print(f"  copy {name}: {ms:.3f} ms, {at:.2f} ms after the scan "
                  f"began, {'inside' if inside else 'outside'} the scan; "
                  f"running: {' <- '.join(frames) or 'unknown'}",
                  flush=True)
        out["routes"][cs] = {"span_ms": span_ms, "kernel_ms": total,
                             "launches": launches, "kernels": table,
                             "copies": copies}
    timestepping._transient_scan = orig
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "profile_heat.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
