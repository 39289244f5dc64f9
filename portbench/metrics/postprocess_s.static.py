"""Mean postprocess seconds of a static call: von Mises and its projection
(solver_stats).
"""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'postprocess_seconds')
