"""Time steps of the heat requests completed in the window over the
window's whole time.
"""

from portbench.lib import readers


def read(run):
    if not (run.window_s > 0):
        return None
    return sum(r['units'] for r in readers.done(run)) / run.window_s
