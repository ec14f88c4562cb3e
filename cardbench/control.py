"""The readings that the check's limits are set from, for one cell:

    python cardbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed it sets the cell up as a run does, runs a short window of
the program, and draws the run's sample of kept answers. It reads the
judged numbers of the program's answers (the lower readings) and of the
control's: the reference itself in the program's place, computed at
TF32 (``reference/tracer.py``), the upper readings. The control returns
the generated triangle it names, so its ``tri_gap`` is 0. Each sample
is traced by its own kind (``harness.occlusion``); where the loop has
``judge``, its own numbers join both sides, the control's from
``judge(sample, v, control=True)``: the loop's reference at TF32 or
float32 in the program's place. Each side's
numbers go through the harness's verdict with the cell's limits. It
prints one JSON line per seed and, last, the largest program reading and
the smallest control reading of each number, and on how many seeds each
side came out correct. The benchmark's own runs do not run it.
"""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None, roots=None, device=None, out=None) -> int:
    import torch

    from cardbench.core import harness, judge
    from cardbench.core.grids import seed_rng
    from cardbench.core.specs import Specs
    from cardbench.reference import tracer

    out = out or sys.stdout
    p = argparse.ArgumentParser(prog="cardbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    specs = Specs(roots)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    prog_all, ctl_all, verdicts = [], [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx, loop = harness.prepare(specs, args.workload, seed, device)
        lat, _, _, _ = harness.window(ctx, loop, args.seconds, False)
        chk = ctx.cell["check"]
        samples = loop.samples(seed_rng(seed, harness.CHECK_STREAM, 1),
                               chk["rays_per_slot"])
        loop.release()
        gc.collect()
        prog, ctl = [], []
        for s in samples:
            v = loop.triangles(s["key"])
            r = s["rays"]
            occlusion = harness.occlusion(loop, s)
            args_ = (v, r["o"], r["d"], r["t_min"], r["t_max"])
            ref = tracer.trace(*args_, occlusion=occlusion)
            prog.append(harness.judged(loop, s, v, ref=ref))
            c = tracer.trace(*args_, occlusion=occlusion, precision="tf32")
            got = dict(hit=c["hit"], idx=c["idx"], t=c["t"])
            if "bary" in s["got"]:
                got["bary"] = c["bary"]
            nums = judge.numbers(v, r, got, occlusion=occlusion, ref=ref)
            if "tri_gap" in prog[-1]:
                nums["tri_gap"] = 0.0
            if hasattr(loop, "judge"):
                nums = judge.joined(nums, loop.judge(s, v, control=True))
            ctl.append(nums)
        prog, ctl = judge.combine(prog), judge.combine(ctl)
        prog_all.append(prog)
        ctl_all.append(ctl)
        ok = {side: all(x for _, _, x in judge.verdict(
            nums, chk["limits"]).values())
            for side, nums in (("program", prog), ("control", ctl))}
        verdicts.append(ok)
        print(json.dumps({"seed": seed, "calls": len(lat),
                          "seconds": time.perf_counter() - t,
                          "program": prog, "control": ctl,
                          "program_correct": ok["program"],
                          "control_correct": ok["control"]}), file=out,
              flush=True)
        del ctx, loop, samples
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lower = judge.combine(prog_all)
    upper = {k: min(c[k] for c in ctl_all) for k in ctl_all[0]}
    print(json.dumps({
        "workload": args.workload, "lower": lower, "upper": upper,
        "limits": chk["limits"], "seeds": len(verdicts),
        "program_correct": sum(v["program"] for v in verdicts),
        "control_correct": sum(v["control"] for v in verdicts)}),
        file=out, flush=True)
    return 0


if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    CACHE = ROOT / ".cardbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    sys.exit(main(roots=[ROOT]))
