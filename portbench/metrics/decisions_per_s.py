"""decisions_per_s: every decision whose finished wire values came back
inside the window, over the window's length (host clock)."""


def read(run):
    w = run.win
    done = w["ends"] <= w["t_end"]
    lanes = sum(run.lanes(i) for i, ok in zip(run.launches(), done) if ok)
    return lanes / (w["t_end"] - w["t_start"])
