"""torch_ops_ms.shadow (ms): device time a shadow query in operations that
are not the port's own kernels (PyTorch, CUB/Thrust, CUDA libraries),
memcpys and memsets included (``core/trace.py``)."""


def read(run):
    t = run.trace
    return None if t is None else t.per_call_ms(t.library_s)
