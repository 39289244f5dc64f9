"""Mean seconds of a static call's df2 rounds and checks on the device's
clock (solver_stats ``df2_device_seconds``: two CUDA events around each
round and each check's residual, summed), the host's reads and
turnarounds between them left out."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'df2_device_seconds')
