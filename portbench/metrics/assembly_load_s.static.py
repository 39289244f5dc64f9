"""Mean seconds of a static call's load vector and BC masks, the part of
its assembly a new load case changes (the program's ``assembly.load``
span, solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'assembly_load_seconds')
