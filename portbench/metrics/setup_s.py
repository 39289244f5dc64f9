"""Set-up: from the process's start to the end of the warm-up requests
(import, kernel builds or loads, warm-up).
"""


def read(run):
    return run.setup_s
