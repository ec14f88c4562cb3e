"""query_p95_ms (ms): the 95th percentile (nearest rank) of the wall time
of every query of the window, its end-of-call sync included."""
from cardbench.core.stats import percentile


def read(run):
    return percentile(run.latencies, 95) * 1e3
