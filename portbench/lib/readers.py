"""What the metric readers under ``metrics/`` share: means of the tools'
own timers and counts over the window's requests, and the device's
numbers from the traced requests.  A reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.lib import yardstick


def done(run):
    return [r for r in run.records if r["ok"]]


def mean_stat(run, key: str) -> Optional[float]:
    vals = [float(r["stats"][key]) for r in done(run) if key in r["stats"]]
    return sum(vals) / len(vals) if vals else None


def per_unit(run, key: str, scale: float = 1.0) -> Optional[float]:
    """The window's total of a stat over its total of units (steps)."""
    recs = [r for r in done(run) if key in r["stats"]]
    units = sum(r["units"] for r in recs)
    return scale * sum(float(r["stats"][key]) for r in recs) / units \
        if units else None


def tool_other_s(run) -> Optional[float]:
    """Mean seconds of a call outside its assembly and solve: the tool's
    own work (the trajectory's stacking and packing, the pickle)."""
    recs = [r for r in done(run)
            if {"assembly_seconds", "solve_seconds"} <= set(r["stats"])]
    if not recs:
        return None
    return sum(r["wall_s"] - r["stats"]["assembly_seconds"]
               - r["stats"]["solve_seconds"] for r in recs) / len(recs)


def k1_roofline(run) -> Optional[float]:
    """K1's share of its least time over the traced requests, in %: the
    least times of its launches, each from its level's shape as the launch
    counter names it (yardstick.flat_cost, yardstick.bound), over the
    device time of its launches in the trace.  Launches are grouped by
    instantiation (vdim, weight type, n_off); where the trace holds fewer
    launches of a group than were counted, the group's traced mean time
    stands for each counted launch."""
    tr = run.trace
    if tr is None or not tr.launches:
        return None
    traced = {}
    for op in tr.ops:
        args = yardstick.k1_args(op.name) if yardstick.K1_NAME in op.name \
            else None
        if args is None:
            continue
        key = (args[0], args[1], args[2])
        n, t = traced.get(key, (0, 0.0))
        traced[key] = (n + 1, t + (op.end - op.start) / 1e9)
    counted = {}
    for (vdim, wb, n_off, N), n in tr.launches.items():
        ms, _ = yardstick.bound(*yardstick.flat_cost(n_off, vdim, N, wb)[:2])
        c, b = counted.get((vdim, wb, n_off), (0, 0.0))
        counted[(vdim, wb, n_off)] = (c + n, b + n * ms / 1e3)
    t_bound = t_dev = 0.0
    for key, (n, b) in counted.items():
        if key not in traced:
            continue
        nt, tt = traced[key]
        t_bound += b
        t_dev += tt if nt >= n else tt / nt * n
    return 100.0 * t_bound / t_dev if t_dev > 0 else None


def device_idle(run) -> Optional[float]:
    """% of the traced stretch in which no operation ran on the device."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
