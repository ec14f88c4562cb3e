"""Run one cell of the benchmark of raycore_tpu_torch once, from the root
of a checkout:

    python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints the cell's metrics (end-to-end ones with ``--trace 0``,
per-layer ones with ``--trace 1``), the check against the reference and
the device as one JSON object on the last line of standard output, and
the checked numbers beside their limits as the last lines of standard
error. It needs a CUDA card and exits non-zero without one.
"""
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T0 = process_start()
    ROOT = Path(__file__).resolve().parent.parent
    # Kernel caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds.
    CACHE = ROOT / ".cardbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from cardbench.core import harness
    sys.exit(harness.main(sys.argv[1:], roots=[ROOT], t0=T0))
