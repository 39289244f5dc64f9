"""The window's masked step-solve iterations run past their step's
convergence (the program's ``scan_past_iterations`` counter,
solver_stats) over its time steps: what the scan's step budgets spend
beyond what the steps take."""

from portbench.lib import readers


def read(run):
    return readers.per_unit(run, 'scan_past_iterations')
