"""Mean chunks a heat call runs again step by step after a step outran
its step program's budget (the program's ``scan_reruns`` counter,
solver_stats): what a budget that is too tight costs."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'scan_reruns')
