"""roofline_pct.frame (%): the least time the frame's bytes need at the
H100's HBM bandwidth (``core/work.py``: inputs read once, contractual
outputs written once) over the device's busy time a frame."""
from cardbench.reference.peaks import least_seconds


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * least_seconds(run.work_bytes, 0) / (t.busy_s / t.calls)
