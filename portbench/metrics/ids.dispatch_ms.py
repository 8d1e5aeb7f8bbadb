"""ids.dispatch_ms: mean host ms a launch on the dispatching thread: the
copies of its ids and times queued, BucketTable.check_many_ids (the
front end's ops and the window kernel queued), the copy of its output
queued; a span the harness takes around each launch in the window."""


def read(run):
    d = run.win["dispatch"]
    if not len(d):
        return None
    return float((d[:, 1] - d[:, 0]).mean() * 1e3)
