"""Kernel launches a CG iteration of the static calls: the window's total
of the program's ``kernel_launches`` counter (graph replays included) over
its total ``cg_iterations`` (solver_stats)."""

from portbench.lib import readers


def read(run):
    recs = [r["stats"] for r in readers.done(run)
            if "kernel_launches" in r["stats"]]
    iters = sum(int(s["cg_iterations"]) for s in recs)
    return sum(int(s["kernel_launches"]) for s in recs) / iters \
        if iters else None
