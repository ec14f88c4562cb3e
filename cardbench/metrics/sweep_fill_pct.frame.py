"""sweep_fill_pct.frame (%): the share of K2's rows (pairrow mode) that
hold a live (pair, cluster) candidate: 100 x ``filled`` / ``slots`` of
the program's ``ops/regroup.py:pack_presorted_cluster_major`` counters,
over every frame of the run (``core/spans.py:fill_pct``); nothing where
the program has no such counters."""
from cardbench.core.spans import fill_pct


def read(run):
    return None if run.trace is None else fill_pct()
