"""device.idle: the share of the traced window in which no CUDA record
of the program ran on the card (the union of the records' intervals),
in percent."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
