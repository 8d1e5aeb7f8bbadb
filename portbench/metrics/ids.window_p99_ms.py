"""ids.window_p99_ms: the 99th percentile, over every launch dispatched
in the window, of the time from handing its ids to check_many_ids to its
finished wire values (host clock): the wait a batch caller feels for its
answers, with `in_flight` launches queued.  Host stalls of tens of ms
set its tail, so it is read per layer beside `decisions_per_s`."""

import numpy as np


def read(run):
    w = run.win
    if not len(w["starts"]):
        return None
    return float(np.percentile((w["ends"] - w["starts"]) * 1e3, 99))
