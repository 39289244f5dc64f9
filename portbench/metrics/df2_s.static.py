"""Mean seconds of a static call's df2 F-cycle rounds on the host's clock
(the program's ``solve.df2`` span, solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'df2_seconds')
