"""frame_p95_ms (ms): the 95th percentile (nearest rank) of the wall time
of every frame of the window, its end-of-frame sync included."""
from cardbench.core.stats import percentile


def read(run):
    return percentile(run.latencies, 95) * 1e3
