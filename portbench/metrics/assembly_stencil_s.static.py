"""Mean seconds of a static call's stencil assembly, the load-independent
part of its assembly (the program's ``assembly.stencil`` span,
solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'assembly_stencil_seconds')
