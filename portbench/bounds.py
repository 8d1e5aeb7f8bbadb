"""The yardstick's peaks and the least time of a by-id window.

Frozen copies: `byid_bound_ms` is `chip_smoke.py::byid_bound_ms`, and
the peak is the one `chip_smoke.py` uses (NVIDIA's H100 SXM data sheet:
3.35 TB/s of HBM3).  The program may change; these do not.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, 80 GB HBM3
SECTOR = 32  # bytes: the unit of a DRAM access on the card


def byid_bound_ms(ids, width_out_bytes):
    """(ms, distinct ids) of the least time for one by-id window of raw
    ids i32[K, B]: the ids read once, one 32-byte sector for each
    distinct valid id's resident id row, one sector read and one written
    for its table row (one slot per interned id), the outputs and
    per-sub-batch counts written once, at the HBM rate.  The packed rows
    are the front end's intermediate, not the function's input, so they
    are not counted.  (Copied from chip_smoke.py::byid_bound_ms.)"""
    k, b = ids.shape
    distinct = int(np.unique(ids[ids >= 0]).size)
    moved = (
        k * b * 4  # ids
        + k * 8  # now
        + 3 * distinct * SECTOR  # id rows read; table rows read, written
        + k * b * width_out_bytes  # outputs
        + k * 8  # n_exp
    )
    return moved / HBM_BYTES_PER_S * 1e3, distinct


OUT_BYTES = {"w32": 4, "cur": 8}  # output bytes a request, per tier
