"""Peak device memory allocated over the window, GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
