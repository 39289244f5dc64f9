"""Mean GiB a static call feeds to its content keys' hashes (the program's
``hashed_bytes`` counter, solver_stats)."""

from portbench.lib import readers


def read(run):
    n = readers.mean_stat(run, 'hashed_bytes')
    return None if n is None else n / 2 ** 30
