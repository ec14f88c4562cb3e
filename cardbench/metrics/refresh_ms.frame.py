"""refresh_ms.frame (ms): the harness's span around a frame's transform
updates and ``refresh_instances``, closed by a sync, a frame."""
from cardbench.core.trace import REFRESH_SPAN


def read(run):
    t = run.trace
    if t is None or not t.spans.get(REFRESH_SPAN):
        return None
    spans = t.spans[REFRESH_SPAN]
    return sum(spans) / len(spans) * 1e3
