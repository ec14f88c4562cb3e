"""live_pct.pt (%): the share of the closest queries' lanes that carry a
live path: 100 x ``live`` / (``rays`` / 2) of the program's
``render/pathtracer.py:_frames`` counters over every frame of the run
(each bounce submits one closest and one occlusion query of the same
lanes, so the closest queries took half of ``rays``); nothing where the
program has no such counters."""
import sys


def read(run):
    if run.trace is None:
        return None
    mod = sys.modules.get("raycore_tpu_torch.render.pathtracer")
    counters = getattr(mod, "_frames", None)
    rays = getattr(counters, "rays", 0)
    live = getattr(counters, "live", None)
    if not rays or live is None:
        return None
    return 100.0 * float(live) / (rays / 2)
