"""finish.fetch_ms: mean host ms a worker of the pool waits for a
launch's output to reach its pinned buffer (the event recorded behind
the copy, which follows the launch's kernels), a span per launch."""


def read(run):
    f = run.win["finish"]
    if not len(f):
        return None
    return float((f[:, 1] - f[:, 0]).mean() * 1e3)
