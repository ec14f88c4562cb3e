"""port_kernels_ms.frame (ms): device time a frame in the port's own
kernels (``core/trace.py``)."""


def read(run):
    t = run.trace
    return None if t is None else t.per_call_ms(t.own_s)
