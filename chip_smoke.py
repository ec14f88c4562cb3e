#!/usr/bin/env python3
"""Drive the PyTorch port's closest-hit main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line or more each; any failed check raises and the
script exits non-zero:

  1. environment: card name and power limit (nvidia-smi), torch, CUDA and
     nvcc versions; no CUDA device is an error (there is no CPU fallback);
  2. build both kernels from raycore_tpu_torch/csrc;
  3. build the headline scene (displaced grid n=707, 999,698 triangles,
     C=256), cold and warm;
  4. kernel K1 (phase A) against its plain version on the headline query's
     stats and bounds: bitwise equal;
  5. kernel K2 (regroup sweep) against its plain version on the headline
     query's blocks, within the stated tolerance;
  6. the headline query, closest_hit on 1024^2 Morton-ordered downward rays:
     median of 5 runs, both kernels launched, hit_frac 1.0 at bench.py's 4
     decimals and no miss off the x == y line (those rays run exactly
     along the mesh's diagonal edges);
  7. 4096 sampled headline rays and all 1024 on that line against the
     brute-force oracle: hit masks may differ only on the line, on at
     most DIAG_PORT_MISSES_MAX rays that only the oracle hits and
     DIAG_ORACLE_MISSES_MAX rays that only the port hits;
  8. a depth-complex scene (blobby 354x354, ~250K triangles) with 262,144
     incoherent rays, 4096 of them against the oracle.

The line before the last is a JSON object with each kernel's launches,
error against its plain version and times; the last line is
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

INT32_MAX = 0x7FFFFFFF
SEED = 0
# Hit-mask differences against the oracle allowed among the 1024 headline
# rays on the x == y line, which run exactly along the grid's diagonal
# edges. Neither test is watertight there. The featurized sweep's table
# rounding can exceed its edge slack (30 headline rays miss). The oracle
# evaluates its dots as fused multiply-add chains, as the compiled
# reference oracle does, so on a shared edge u is the rounding error of
# one product and about half the line's rays miss both triangles
# (tests/test_torch_core.py pins that ray for ray against the reference).
DIAG_PORT_MISSES_MAX = 64
DIAG_ORACLE_MISSES_MAX = 640


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps, inner=1):
    """Median device time of one call of ``fn`` in ms over ``reps``
    samples of ``inner`` back-to-back calls each (CUDA events)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def check_hits(ref, got, what, edge=None, max_only_ref=0, max_only_got=0):
    """The parity contract of the JAX package's engine tests: equal hit
    masks; t within rtol 2e-5 / atol 2e-6 where both hit; a differing prim
    only as a t tie below 2e-6 relative. Hit masks may differ only on the
    rows flagged by ``edge``: at most ``max_only_ref`` rows where only ref
    hits and ``max_only_got`` where only got hits. Returns (rows where both
    hit, prim ties, rows where only ref hits, rows where only got hits)."""
    rh, gh = ref.hit.cpu().numpy(), got.hit.cpu().numpy()
    flip = rh != gh
    edge = np.zeros_like(flip) if edge is None else edge.cpu().numpy()
    only_ref, only_got = int((rh & ~gh).sum()), int((gh & ~rh).sum())
    if ((flip & ~edge).any() or only_ref > max_only_ref
            or only_got > max_only_got):
        raise AssertionError(
            f"{what}: {int((flip & ~edge).sum())} hit-mask differences off "
            f"the edge rows (none allowed); {only_ref} rows hit only in the "
            f"reference (at most {max_only_ref}) and {only_got} only in the "
            f"result (at most {max_only_got})")
    both = rh & gh
    rt, gt = ref.t.cpu().numpy()[both], got.t.cpu().numpy()[both]
    np.testing.assert_allclose(gt, rt, rtol=2e-5, atol=2e-6, err_msg=what)
    pm = ref.prim_idx.cpu().numpy()[both] == got.prim_idx.cpu().numpy()[both]
    if not pm.all():
        rel = np.abs(gt[~pm] - rt[~pm]) / np.maximum(rt[~pm], 1e-6)
        if rel.max() >= 2e-6:
            raise AssertionError(f"{what}: differing prim without a t tie "
                                 f"(rel {rel.max():.3g})")
    return int(both.sum()), int((~pm).sum()), only_ref, only_got


def morton_grid_rays(side, device):
    """bench.py's headline rays: a side x side grid at z=3 over
    [-0.95, 0.95]^2 looking down, in Morton pixel order."""
    xs = np.linspace(-0.95, 0.95, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    o = np.stack([X, Y, np.full_like(X, 3.0)], -1).reshape(-1, 3)

    def spread(v):
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    z = spread(np.arange(side, dtype=np.uint64))
    code = (z[:, None] << np.uint64(1)) | z[None, :]
    o = o[np.argsort(code.reshape(-1), kind="stable")]
    d = np.broadcast_to(np.array([0.0, 0.0, -1.0], np.float32), o.shape)
    return torch.as_tensor(o, device=device), \
        torch.as_tensor(np.ascontiguousarray(d), device=device)


def main():
    # 1. Environment.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    import raycore_tpu_torch as rt
    from raycore_tpu_torch.kernels import _build
    from raycore_tpu_torch.ops import dense as ops_dense
    from raycore_tpu_torch.ops import regroup as ops_regroup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    say(1, f"card {torch.cuda.get_device_name(0)} | {smi} | torch "
           f"{torch.__version__} CUDA {torch.version.cuda} | {nvcc}")

    # 2. Kernels.
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    say(2, f"kernels built from {_build.SRC_DIR.name}/ in "
           f"{time.perf_counter() - t0:.2f} s")

    # 3. Headline scene.
    mesh = rt.displaced_grid_mesh(n=707, extent=2.0, amplitude=0.35,
                                  device=dev)

    def build():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = rt.build_dense(mesh, cluster_size=256)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t) * 1e3

    scene, build_cold_ms = build()
    scene, build_warm_ms = build()
    say(3, f"scene {mesh.vertices.shape[0]} tris, capacity {scene.n_prims}, "
           f"K {scene.n_clusters}, tri_feats {tuple(scene.tri_feats.shape)}; "
           f"build cold {build_cold_ms:.1f} ms warm {build_warm_ms:.1f} ms; "
           f"allocated {torch.cuda.memory_allocated() / 2**20:.0f} MiB")

    o, d = morton_grid_rays(1024, dev)
    rays = rt.Ray.create(o, d)
    po, pd, ptmin, ptmax, R0, G, TILE = ops_regroup._padded_batch(
        rays, 2048, 32)
    SPB, C = 16, scene.cluster_size

    # 4. K1 against its plain version, bitwise.
    stats, bounds = ops_dense.phase_a_inputs(
        scene.cluster_min, scene.cluster_max, po, pd, ptmin, ptmax,
        po.shape[0] // TILE, TILE)
    ek = ops_dense.phase_a(stats, bounds)
    ep = ops_dense.phase_a_plain(stats, bounds)
    torch.cuda.synchronize()
    if not torch.equal(ek.view(torch.int32), ep.view(torch.int32)):
        raise AssertionError(
            f"K1: {int((ek.view(torch.int32) != ep.view(torch.int32)).sum())}"
            f" of {ek.numel()} entries differ from the plain version")
    fin = torch.isfinite(ek)
    k1_err = float((ek[fin] - ep[fin]).abs().max()) if fin.any() else 0.0
    k1_ms = cuda_ms(lambda: ops_dense.phase_a(stats, bounds), 5, inner=50)
    k1_plain_ms = cuda_ms(lambda: ops_dense.phase_a_plain(stats, bounds), 5,
                          inner=10)
    say(4, f"K1 phase_a {tuple(ek.shape)}: bitwise equal, "
           f"{int(fin.sum())} finite pairs; kernel {k1_ms:.4f} ms plain "
           f"{k1_plain_ms:.4f} ms")

    # 5. K2 against its plain version on the headline blocks.
    block_cid, block_subs, tbl, counts = ops_regroup._stage1_cm_core(
        scene, po, pd, ptmin, ptmax, TILE, G, SPB)
    n_blocks = block_cid.shape[0]
    sweep = dict(G=G, SPB=SPB, C=C)
    kk, pk = ops_regroup.run_regrouped(block_subs, block_cid, tbl,
                                       scene.tri_feats, **sweep)
    kp, pp = ops_regroup.run_regrouped_plain(block_subs, block_cid, tbl,
                                             scene.tri_feats, **sweep)
    torch.cuda.synchronize()
    hk, hp = kk != INT32_MAX, kp != INT32_MAX
    rows = kk.numel()
    flips = int((hk != hp).sum())
    both = hk & hp
    tk, tp = kk[both].view(torch.float32), kp[both].view(torch.float32)
    k2_err = float((tk - tp).abs().max()) if both.any() else 0.0
    rel = float(((tk - tp).abs() / tp.abs().clamp_min(1e-6)).max()) \
        if both.any() else 0.0
    same_key = both & (kk == kp)
    pair_diff = int((pk[both] != pp[both]).sum())
    tie_diff = int((pk[same_key] != pp[same_key]).sum())
    say(5, f"K2 regroup_sweep: {n_blocks} blocks ({counts[0]} coarse pairs, "
           f"{counts[1]} subgroup pairs), {rows} rows, {int(hp.sum())} plain "
           f"hits; hit-mask flips {flips}, pair differences {pair_diff} "
           f"({tie_diff} where the keys are equal), max rel t {rel:.3g}")
    if flips > 1e-5 * rows:
        raise AssertionError(f"K2: {flips} hit-mask flips > 1e-5 of {rows}")
    if rel > 2e-6:
        raise AssertionError(f"K2: decoded t differs by rel {rel:.3g} > 2e-6")
    if tie_diff:
        raise AssertionError(f"K2: {tie_diff} rows with equal keys name "
                             f"different triangles")
    k2_ms = cuda_ms(lambda: ops_regroup.run_regrouped(
        block_subs, block_cid, tbl, scene.tri_feats, **sweep), 10)
    k2_plain_ms = cuda_ms(lambda: ops_regroup.run_regrouped_plain(
        block_subs, block_cid, tbl, scene.tri_feats, **sweep), 3)
    say(5, f"K2 kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms")
    del kk, pk, kp, pp, hk, hp, both, same_key

    # 6. The headline query through the public entry point.
    counters = {"phase_a": ops_dense.phase_a,
                "regroup_sweep": ops_regroup.run_regrouped}
    for fn in counters.values():
        fn.launches = 0
    res = rt.closest_hit(scene, rays)                 # warm-up
    torch.cuda.synchronize()
    walls = []

    def query():
        nonlocal res
        t = time.perf_counter()
        res = rt.closest_hit(scene, rays)
        walls.append(time.perf_counter() - t)

    q_ms = cuda_ms(query, 5)
    launches = {k: fn.launches for k, fn in counters.items()}
    hit_frac = float(res.hit.float().mean())
    # The rays with x == y run exactly along the grid cells' diagonal
    # edges, where neither the exact oracle nor the featurized test (whose
    # table rounding can exceed its edge slack there) is watertight.
    diag = o[:, 0] == o[:, 1]
    off_diag_misses = int((~res.hit & ~diag).sum())
    say(6, f"closest_hit {mesh.vertices.shape[0]} tris x {R0} rays: "
           f"{q_ms:.2f} ms median of 5 ({R0 / q_ms / 1e3:.3f} Mrays/s; "
           f"host wall median "
           f"{statistics.median(walls) * 1e3:.2f} ms) on {smi}; hit_frac "
           f"{hit_frac} ({int((~res.hit).sum())} misses, "
           f"{off_diag_misses} off the x == y edge line); launches "
           f"{launches}; n_blocks {n_blocks}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    # bench.py reports hit_frac to 4 places.
    if round(hit_frac, 4) != 1.0 or off_diag_misses:
        raise AssertionError(f"hit_frac {hit_frac}, {off_diag_misses} misses "
                             f"off the x == y line")
    if res.t.shape != (R0,) or not bool(torch.isfinite(res.t).all()):
        raise AssertionError("headline t is not finite or has the wrong "
                             "shape")

    # 7. Oracle on a seeded sample of the headline rays plus every ray on
    # the x == y line. Hit masks may differ only on that line, where
    # neither test is watertight.
    rng = np.random.default_rng(SEED)
    pick = np.union1d(rng.choice(R0, 4096, replace=False),
                      torch.nonzero(diag).squeeze(1).cpu().numpy())
    idx = torch.as_tensor(pick, device=dev)
    sample = rt.Ray.create(o[idx], d[idx])
    ref = rt.closest_hit_brute(scene.prims, sample)
    n_hit, n_tie, only_ref, only_port = check_hits(
        ref, res.map(lambda a: a[idx]), "headline", edge=diag[idx],
        max_only_ref=DIAG_PORT_MISSES_MAX,
        max_only_got=DIAG_ORACLE_MISSES_MAX)
    say(7, f"headline sample vs brute oracle: {idx.numel()} rays "
           f"({int(diag[idx].sum())} on the x == y line); {n_hit} hits "
           f"agree, {n_tie} prim ties; on the line {only_ref} hit only in "
           f"the oracle (at most {DIAG_PORT_MISSES_MAX}) and {only_port} "
           f"only in the port (at most {DIAG_ORACLE_MISSES_MAX})")

    # 8. Depth-complex scene with incoherent rays.
    blob = rt.blobby_mesh(n_theta=354, n_phi=354, device=dev)
    bscene = rt.build_dense(blob, cluster_size=256)
    # Incoherent rays: origins on a sphere of radius 3, each aimed at its
    # own random point of the blob's box, so hits cross several layers
    # and rays near the silhouette miss.
    Rb = 262144
    bo = rng.normal(size=(Rb, 3))
    bo *= 3.0 / np.linalg.norm(bo, axis=1, keepdims=True)
    bd = rng.uniform(-1.0, 1.0, (Rb, 3)) - bo
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    brays = rt.Ray.create(torch.as_tensor(bo, dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(bd, dtype=torch.float32,
                                          device=dev))
    t = time.perf_counter()
    bres = rt.closest_hit(bscene, brays)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t) * 1e3
    bidx = torch.as_tensor(rng.choice(Rb, 4096, replace=False), device=dev)
    bref = rt.closest_hit_brute(bscene.prims, rt.Ray.create(
        brays.o[bidx], brays.d[bidx]))
    n_hit, n_tie, _, _ = check_hits(bref, bres.map(lambda a: a[bidx]),
                                    "blobby")
    say(8, f"blobby {blob.vertices.shape[0]} tris x {Rb} incoherent rays: "
           f"hit_frac {float(bres.hit.float().mean()):.4f}, first query "
           f"{b_ms:.1f} ms; sample vs oracle: {n_hit}/{bidx.numel()} hits "
           f"agree, {n_tie} prim ties")

    kernels = [
        {"name": "phase_a", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/phase_a.cu",
         "replaces": "raycore_tpu/ops/pallas_dense.py:445",
         "launches": launches["phase_a"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "regroup_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/regroup_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_regroup.py:191",
         "launches": launches["regroup_sweep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
