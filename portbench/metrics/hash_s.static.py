"""Mean seconds a static call spends hashing its content keys (the
program's ``setup.hash`` spans: the prep key, the hierarchy key and the
projection's prep key; solver_stats)."""

from portbench.lib import readers


def read(run):
    return readers.mean_stat(run, 'hash_seconds')
