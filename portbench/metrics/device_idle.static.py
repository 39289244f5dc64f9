"""Idle share of the device over the traced static requests, in %."""

from portbench.lib import readers


def read(run):
    return readers.device_idle(run)
