"""Mean CUDA graphs a static call captures after the warm-up (the
program's ``graphs_captured`` counter, solver_stats): 0 when every
program is kept across calls."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'graphs_captured')
