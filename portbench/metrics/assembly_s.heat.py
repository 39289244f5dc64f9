"""Mean assembly seconds of a heat call (solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'assembly_seconds')
