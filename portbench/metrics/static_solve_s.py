"""The window's whole time over the static requests it completed: the mean
wait for a solution.
"""

from portbench.lib import readers


def read(run):
    return run.window_s / len(readers.done(run)) if readers.done(run) else None
