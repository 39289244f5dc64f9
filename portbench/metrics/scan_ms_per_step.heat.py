"""The window's scan seconds over its time steps, in ms."""

from portbench.lib import readers


def read(run):
    return readers.per_unit(run, 'scan_seconds', 1e3)
