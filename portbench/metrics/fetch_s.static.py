"""Mean seconds of a static call's answer to the host: the df pair's copy,
its sum in float64 and the unscaling (the program's ``solve.fetch``
span, solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'fetch_seconds')
