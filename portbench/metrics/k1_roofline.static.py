"""K1's share of its least time in the traced static requests, in %."""

from portbench.lib import readers


def read(run):
    return readers.k1_roofline(run)
