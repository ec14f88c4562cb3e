"""port_kernels_ms.query (ms): device time a query in the port's own
kernels (``core/trace.py``)."""


def read(run):
    t = run.trace
    return None if t is None else t.per_call_ms(t.own_s)
