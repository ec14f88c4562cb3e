"""host_syncs.frame (syncs/frame): the program's host syncs a frame, the
harness's end-of-call sync left out (``core/trace.py``)."""


def read(run):
    t = run.trace
    return None if t is None else t.syncs / t.calls
