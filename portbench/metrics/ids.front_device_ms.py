"""ids.front_device_ms: mean device ms a launch of every CUDA record of
the launch but the window kernel and the copies (the by-id front end,
kernel.ids_window, and the expired-hit sum), from the traced run's one
profiler session, each record given to the launch that queued it."""


def read(run):
    if run.trace is None:
        return None
    return float(run.trace["front_ms"].mean())
