"""port_kernels_ms.shadow (ms): device time a shadow query in the port's
own kernels (``core/trace.py``)."""


def read(run):
    t = run.trace
    return None if t is None else t.per_call_ms(t.own_s)
