"""The window's CG iterations over its time steps."""

from portbench.lib import readers


def read(run):
    return readers.per_unit(run, 'cg_iterations')
