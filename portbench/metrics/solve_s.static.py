"""Mean solve seconds of a static call: prep and hierarchy lookups, the df2
rounds (solver_stats).
"""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'solve_seconds')
