"""finish.w32_ms: mean host ms of the host finish of a launch's output
(kernel.finish_w32, or the native finish_raw in the cur tier) on the
worker pool, a span per launch."""


def read(run):
    f = run.win["finish"]
    if not len(f):
        return None
    return float((f[:, 2] - f[:, 1]).mean() * 1e3)
