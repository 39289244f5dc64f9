"""Mean assembly seconds of a static call (solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'assembly_seconds')
