"""Mean set-up seconds of a heat call's scan: prep, hierarchy, staging
(solver_stats).
"""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'setup_seconds')
