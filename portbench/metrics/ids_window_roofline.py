"""ids_window_roofline: the least time of each traced launch's by-id
window (bounds.byid_bound_ms of its ids, its tier's outputs) over the
device time of its front end and window kernel, summed over the traced
launches, in percent.  It counts the by-id window's work, not the front
end's intermediate, so it reads the same work whatever implements it."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    device = float(t["front_ms"].sum() + t["window_ms"].sum())
    if device <= 0:
        return None
    return 100.0 * sum(run.bound_ms(i) for i in run.launches()) / device
