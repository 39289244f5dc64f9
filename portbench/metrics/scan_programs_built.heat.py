"""Mean step programs a heat call builds after the warm-up (the
program's ``scan_programs_built`` counter, solver_stats): 0 when every
window request runs on the step programs the warm-up captured."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'scan_programs_built')
