#!/usr/bin/env python3
"""Drive the PyTorch port's closest-hit and any-hit paths once on one CUDA
card.

    python3 chip_smoke.py

Phases, one printed line or more each; any failed check raises and the
script exits non-zero. Each query path runs with every kernel's launch
count set to 0 just before it and read just after:

  1. environment: card name and power limit (nvidia-smi), torch, CUDA and
     nvcc versions; no CUDA device is an error (there is no CPU fallback);
  2. build the kernels (K1-K8) from raycore_tpu_torch/csrc;
  3. build the headline scene (displaced grid n=707, 999,698 triangles,
     C=256), cold and warm;
  4. kernel K1 (phase A) against its plain version and its model
     (ops/dense.py:phase_a_model) on the headline query's stats and
     bounds: bitwise equal; its time beside an empty launch on its grid
     (the launch floor) and its bytes and operations bounds;
  5. kernel K2 (regroup sweep) against its plain version on the headline
     query's blocks, within the stated tolerance, and bit for bit against
     its kernel-order model on sampled blocks; K5 (packed sweep) at one
     sub-chunk per cluster and one block per CTA on the same blocks,
     bitwise equal to K2 and timed beside it;
  6. the headline query, closest_hit on 1024^2 Morton-ordered downward rays
     (the regrouped engine, K1, K7 and K2): median of 5 runs, the three
     kernels launched, hit_frac 1.0 at bench.py's 4 decimals and no miss
     off the x == y line (those rays run exactly along the mesh's diagonal
     edges);
     the scene's depth_layers and the passes dispatch gives it; the
     regrouped engine at passes 1 and 4 (what "auto" resolves to there)
     timed in turns, each held to the query's result ray for ray;
  7. 4096 sampled headline rays and all 1024 on that line against the
     brute-force oracle: hit masks may differ only on the line, on at
     most DIAG_PORT_MISSES_MAX rays that only the oracle hits and
     DIAG_ORACLE_MISSES_MAX rays that only the port hits;
  8. a depth-complex scene (blobby 354x354, ~250K triangles) with 262,144
     incoherent rays through closest_hit (the tile worklist, K1 and K3),
     4096 of them against the oracle with the worklist's tie bound; the
     steady state of the worklist and of the regrouped engine on them;
  9. closest_hit on 512^2 headline rays (a renderer's primary pass),
     which dispatch sends to the tile worklist: the query's median time
     and an oracle sample with the worklist's tie bound;
 10. the same rays on the headline mesh built with sub_chunks=4 (K3's
     per-sub-chunk slab skip, counted by the plain version) and an oracle
     sample;
 11. shadow rays from the 512^2 and 1024^2 headline hit points toward a
     light: any_hit on 262,144 rays takes the worklist occlusion (K4), on
     1,048,576 the regrouped occlusion (K2); hit masks against the
     oracle, and every occluder checked as a genuine intersection;
 12. the 1024^2 headline rays on phase 10's sub_chunks=4 scene, which
     dispatch sends to the packed engine (K1, K7 and K5, C_eff = 64): the
     query's median time, no miss off the x == y line, phase 6's
     regrouped result ray for ray (equal hit masks, t within 2e-6
     relative, a differing prim only as such a tie; the count of rays
     bitwise identical in hit, t and prim) and an oracle sample;
 13. closest_hit_packed on the sub_chunks=1 headline scene (C_eff = C =
     256) against phase 6's result in the same way;
 14. the dense brute-force sweep (K6), closest_hit_brute_pallas on a
     65,024-triangle sphere and 512^2 pinhole rays: bit for bit against
     its plain version on a 16,384-ray subset and against the oracle on
     a 4096-ray sample; its bound from the tests this data needs (each
     test stops once u, then v, fails), and the share of (warp, triangle)
     steps whose vote sent the warp to the division;
 15-18. the card probes (raycore_tpu_torch/tools/), each at its tool's
     default shapes: every variant of its kernel against its plain
     version, then the tool's rows through the tool's main(), which is
     the path whose launches are counted: 15 the row gather (P1; loop,
     onehot and take each an entry of the kernels line, onehot's with the
     time of its products at the bf16 peak beside its bound; loop and
     take bit for bit their kernel-order model, their tier, their rate
     over the rows fetched and the card's on-chip ceiling, their times on
     indices free of bank conflicts, and both tiers timed side by side
     across table sizes), 16 the
     worklist epilogue variants (P2; every variant at the tool's 8,192
     blocks under both seeds, the accepted share under the tool's key0
     seed, which accepts nothing, and under a finite one), 17 the
     small-depth contraction by precision tier (P3; every row held to its
     plain version at 8,192 steps, and its 32,768-step time at least 3.5x
     its 8,192-step time), 18 the regroup-block ablations (P4; every row
     held to its plain version at the tool's 8,192 blocks, and the share
     of pairs its division-free pre-test refuses), its full block beside
     K2's time per block.
 19. the blobby 1M cell (bench.py's RAYCORE_BENCH_SCENE=blobby:
     blobby_mesh(707, 707), C=256, the 1024^2 Morton grid), the ordered
     multiwave's: the scene's build, depth_layers and the passes that
     "auto" and dispatch resolve; closest_hit through dispatch (K1 and K7
     once, K2 once or, on the multiwave route, twice); the regrouped engine at
     passes 1, 2 and 4 timed in turns, with each one's swept (subgroup,
     cluster) rows; K2 against its plain version and bit for bit against
     its kernel-order model on sampled blocks of passes=4's wave grid and
     remainder grid; passes 2 and 4 against passes 1 ray for ray (equal
     hit masks, a differing prim only as a t tie, the count of bitwise
     identical rays); a 4096-ray oracle sample.
 20. the 256-instance dynamic frame (tools/tpu_instanced_bench.py at its
     defaults): 256 instances of three base meshes pushed one by one into
     a TLAS, sync and bake_instanced (C=128), cold and warm; closest_hit
     on a 1024^2 downward grid through dispatch (the instanced engine:
     K1, K7 and K2, in its pairrow mode, once each and no other kernel); five
     frames that move every instance, each refresh_instances plus the
     query, in Mrays/s; K1 bitwise against its plain version and K2
     against its plain version and bit for bit against its kernel-order
     model on the frame's blocks; a 4096-ray sample against the
     traversal and the brute-force oracle on the baked world soup
     (flatten_world_triangles) within 2e-4, every disagreement at a
     triangle's edge; any_hit's hit mask equal to the closest hit's; the
     traversal timed on 65,536 of the rays.
 21. the path-traced production frame (tools/tpu_pathtracer_bench.py at
     its defaults, BASELINE config #5): the heightfield of phase 3 with
     two materials, 1024^2 pixels, 4 bounces, through
     render/pathtracer.py:trace_paths_staged, 8 queries of 1,048,576 rays
     a frame (the regrouped engine: K1, K7 and K2 once a query and no
     other kernel); one warm-up frame, then frames seeded 0, 1 and 2 timed
     whole (CUDA events, host syncs included): median, range, Mrays/s; a frame
     with every query synced and timed (live rays, closest, shadow,
     glue); seed 0 twice bitwise equal; the image finite, in [0, 1], mean
     above 0.01; bounce 2's closest query, 4096 sampled live rays,
     against the oracle (hit masks may differ only within 1e-4 of a
     triangle edge) and its shadow query's occluders against the exact
     test; K1 and K2 on the operands of each of the frame's 8 queries;
     stage 1 against the whole query on bounce 0's closest and
     shadow queries and bounce 2's closest query;
     trace_paths_staged_batch with 2 and with 4 frames (2,097,152 and
     4,194,304 rays a query), each frame within 1e-6 of its solo frame.
 22. the renderers and analyses on the card against their CPU twins,
     both drawing from a CPU generator seeded alike: on the room
     (render/scenes.py:example_scene) render_staged at 64x48,
     trace_paths_staged at 32x24 with 3 bounces plain and textured,
     render_step_mts, the simple.py kernels, hits_from_grid and
     get_illumination on a 64^2 grid, view_factors on two facing quads,
     collide_instances on particle_scene's 1,024 particles; a 256x192
     2-bounce frame on displaced_grid_mesh(128) at C=128 (the tile
     worklist: K1, K3 and K4, each held to its plain version and its
     model on every query of the card's frame). Integer outputs equal;
     every image under the image rule of render/parity.py.
 23. the rounds engine (closest_hit_dense at its defaults) on the
     headline: one counted query (K1 once and no other kernel), the
     median and range of 3 more, the rounds taken; K1 bit for bit
     against its plain version on this query's operands; the hits
     against phase 6's regrouped result under the engine contract (t and
     prim ties within ROUNDS_TIE: the engine reports the featurized t)
     with phase 7's x == y rule, and a 4096-ray oracle sample;
     any_hit_dense on phase 11's 1M shadow rays under phase 11's rule
     and against the regrouped any_hit; morton_sort_rays on a shuffled
     copy of the grid, queried and un-permuted, against the plain query.
 24. BVH4 on the headline mesh: build_blas4 timed cold and warm, its rows
     equal to a CPU collapse of the same BVH2 rows; closest_hit4 and
     any_hit4 on 65,536 of the grid's rays against the binary traversal
     on the same BLAS and a 4096-ray oracle sample, each in Mrays/s.
 25. the accel protocol, the transport records and the IO: TLASAccel
     and BruteAccel on tests/test_contract.py's scene (they must agree);
     trace_closest_hits on phase 20's 256-instance StaticTLAS against the
     oracle; save_scene/load_scene of the headline DenseScene (file size,
     seconds; tables and the headline query bit for bit); load_obj
     (native) of the headline mesh written as OBJ with %.9g (seconds;
     build_dense on it gives the tables bit for bit).
 26. the two-phase classifier on CLASSIFIER_TILES headline tiles, every
     cluster phase A keeps: one bf16 pass (classify_block) and bf16x3,
     sound against float64 truth, and the share of ambiguous rays.
 27. ray sharding: SHARD_RANKS gloo ranks on the one card
     (python -m raycore_tpu_torch.parallel.dryrun): the sharded dense
     query on the headline (K1 and K2 once per rank) against phase 6's
     result, and distributed_illumination and distributed_closest_hit on
     a two-instance StaticTLAS against the single process.
 28. kernel K7 (the subgroup refine, ops/regroup.py:refine_pairs) on the
     1M primary query's operands (phase 6's rays) and on the 1M shadow
     query of the benchmark's two lights, swept in octant order: each
     query through its entry point (K1, K7 and K2 once each); on the
     operands the engine builds (``_swept_batch``), K1 bitwise against
     its plain version and its model, then K7 the same; the refine's keep
     share; K7's time (a CUDA graph of 50 calls, and calls launched from
     the host back to back) beside its bound and its plain version's.
 29. kernel K8 (the instanced frame's affine arithmetic, ops/affine.py)
     at the benchmark's refit frame (cardbench's dynamic-128.refit-1m,
     set up by its harness): one frame (K1, K7 and K2 once, K8's refresh
     once and its local rays twice); then on that frame's operands the
     refresh (128 instances), stage 1's pair rows and the finalize's 1M
     rays, each bitwise against its plain version, timed from a CUDA
     graph of 50 calls and from calls launched from the host, beside its
     bound (its bytes once) and its plain version's time.

Every query path (phases 6, 8-14, 19-23, 28 and 29) also holds the kernels it
launched against their plain versions on that path's own operands: K1
bitwise on its phase-A inputs (and against its model), and its sweep
kernel (K2-K6) on its own blocks or rays (K7 in phase 28). Every kernel
that a path does not name must not launch on it.
Phases 8-11 also hold K3 and K4 bit for bit against their kernel-order
model (ops/dense.py:kernel_order_hits) on SAMPLE_TILES sampled tiles with
all their blocks, and phase 11 counts K4's tests per warp beside the
tests its rays need; phase 22 holds K1, K3 and K4 so on the grid frame's
queries. Phases 5 (the headline's blocks, which phase 6's
query sweeps), 11 (the 1M shadow rays' blocks), 12-13 and 21 (every
query of the path-traced frame) hold K2 and K5
bit for bit against theirs (ops/regroup.py:run_regrouped_model,
run_packed_model) on SAMPLE_BLOCKS sampled blocks plus the block with the
most dummy slots; their bounds count only live rows (not the dummy
subgroup that pads a cluster's last block). Phase 13 also times K5 with
its slices staged whole against the launched 64-lane chunks.

The line before the last is a JSON object with each kernel's launches on
its path, error against its plain version, times and bound (K1 twice: on
the headline and on the rounds engine's headline query; K2 three
times: on the headline, on the blobby cell's multiwave path and on the
256-instance frame in its pairrow mode; K1 and K2 once more on the
path-traced frame, with one frame's launches and the sums of their
times and bounds over its 8 queries; K7 twice, on the 1M primary and
shadow queries; K8 three times, the refit frame's refresh, pair rows and
finalize rays; the probe P1 three times, its loop, onehot and take
kernels); the line
before it the script's wall time; the last line is {"ok": true,
"device": {...}}.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

INT32_MAX = 0x7FFFFFFF
SEED = 0
# The headline scene (bench.py's defaults): displaced_grid_mesh(707),
# 999,698 triangles, at C = HEADLINE_C.
HEADLINE_MESH = dict(n=707, extent=2.0, amplitude=0.35)
HEADLINE_C = 256
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
# Shadow rays start 1e-3 above their own surface. The featurized test
# computes u*det, v*det and t*det as dots of world-space features, so its
# rounding error is absolute while det is small (about 6e-6 for the
# headline's cells): u and v move by up to about 2e-4 there (ROADMAP
# queue 3, F1), past the 1e-5 edge slack, and t near the origin moves
# likewise. The JAX kernel does the same arithmetic. So:
# - an occluder that the exact test (slack 1e-4) rejects must pass it with
#   the slack EDGE_ROUNDING_SLACK; at most FAKE_OCCLUDERS_MAX rays of a
#   pass may report such an occluder. It is a ray through a shared edge,
#   credited to the triangle on the other side. Seen: 2 of the 262,144
#   worklist rays and 1 of the 1,048,576 regrouped ones, each with u + v
#   or v past the edge by 1.1e-4 to 1.9e-4 at t 0.056-0.11.
# - where the oracle's hit or the port's occluder lies within
#   NEAR_SURFACE_T of the origin, at most NEAR_SURFACE_FLIPS_MAX rays of a
#   4096-ray sample may disagree with the oracle; elsewhere none may.
#   Seen: none on either pass.
EDGE_ROUNDING_SLACK = 1e-3
FAKE_OCCLUDERS_MAX = 8
NEAR_SURFACE_FLIPS_MAX = 4
NEAR_SURFACE_T = 1e-2
SHADOW_LIFT = 1e-3
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): float32 outside the
# tensor cores and HBM bandwidth. A kernel's bound is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The tensor cores' dense peaks (the probes' wgmma variants).
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# Float32 additions outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations, an addition issues at the same rate.
PEAK_FP32_ADDS = PEAK_FP32_FLOPS / 2
# P3: the least ratio of the 32,768-step time to the 8,192-step time; a
# product hoisted out of the step loop would leave it near 1.
STEP_RATIO_MIN = 3.5
# One featurized (ray, triangle) test: the 19 nonzero terms of its four
# dots (det rows 0-2, u*det and v*det rows 0-5, t*det rows 6-9; the other
# 21 coefficients of the 10-deep dots are zero by construction), 19 fused
# multiply-adds = 38 floating-point operations, the work these inputs need
# in K2-K5. The epilogue (reciprocal, three products, compares) is not
# counted, so the bound stays a floor.
TEST_FLOPS = 38
# One slab test of a ray against a sub-chunk's box: per axis two
# differences and two products (the min/max are not counted).
SLAB_FLOPS = 12
# The scalar Möller–Trumbore test of the dense sweep (K6), its edges
# computed once per triangle, stops once u (then v) fails. A cross product
# is 3 products and 3 fused multiply-adds (9 FLOP), a 3-term dot 1 product
# and 2 fused multiply-adds (5 FLOP). Every test runs up to u: d x e2, det,
# the reciprocal, o - v0 (3), and u's dot and product. A test that passes
# u adds (o - v0) x e1, v's dot and product and u + v; one that passes v
# adds t's dot and product. 46 FLOP in all.
BRUTE_U_FLOPS = 9 + 5 + 1 + 3 + 5 + 1
BRUTE_V_FLOPS = 9 + 5 + 1 + 1
BRUTE_T_FLOPS = 5 + 1
# Phase A's fast arithmetic (csrc/entry.cuh:entry_fast) for one (tile,
# cluster) pair: per axis 2 differences, 4 products, 6 min/max and the
# t_lo / t_hi updates (14), then the entry's max, the exit's min and their
# compare. Its selects and the wide test are not counted.
K1_PAIR_FLOPS = 3 * 14 + 3
# The subgroup refine (K7) computes K1's entry for each (pair, subgroup).
K7_ENTRY_FLOPS = K1_PAIR_FLOPS
# The benchmark's shadow cell's two lights (cardbench/traffic/shadow2-1m):
# rays toward them from the headline surface mix two direction octants.
REFINE_LIGHTS = ((2.5, -2.5, 4.0), (-2.0, 2.0, 3.5))
# The dense sweep's cell: sphere_mesh(n_theta, n_phi) (65,024 triangles),
# a BRUTE_SIDE^2 pinhole view, and the subset its plain version checks.
BRUTE_SPHERE = (128, 256)
BRUTE_SIDE = 512
BRUTE_SUBSET = 16384
# The blobby 1M cell (phase 19): bench.py's RAYCORE_BENCH_SCENE=blobby at
# its defaults, blobby_mesh(707, 707) and the 1024^2 Morton grid.
MULTIWAVE_BLOBBY = 707
MULTIWAVE_SIDE = 1024
# The 256-instance frame (phase 20): tools/tpu_instanced_bench.py at its
# defaults. INSTANCED_COUNT instances of three base meshes, centres from
# default_rng(INSTANCED_SEED), a INSTANCED_SIDE^2 downward grid, and
# INSTANCED_FRAMES frames that each move every instance by
# INSTANCED_STEP; the traversal is timed on a 1-in-16 subset of the rays.
INSTANCED_COUNT = 256
INSTANCED_SEED = 7
INSTANCED_SIDE = 1024
INSTANCED_FRAMES = 5
INSTANCED_STEP = 0.03
INSTANCED_TRAVERSAL_STRIDE = 16
# Against the oracle (world space) and the traversal, the engine tests in
# each instance's local space, so t agrees within
# tests/test_instanced_engine.py's 2e-4 (rtol and atol). Its featurized
# test accepts a barycentric slack of 1e-5 where the exact tests accept
# none, and its table rounds differently (ROADMAP F1), so a ray that
# passes within that of a triangle's outer edge (a box's rim, a
# silhouette) may hit it in one test and pass it in the other: a hit-mask
# difference, or both hit and name winners whose t differ past the
# tolerance. Such a disagreement is allowed where the nearer of the two
# winners, tested exactly in float64 in world space, has a barycentric
# coordinate within INSTANCED_EDGE of 0, and on at most
# INSTANCED_EDGE_RATE of the rays compared (at least 4). Seen: 1 of the
# 4096 sampled rays on an NVIDIA H100 (PERF.md §5), whose t differed by
# 0.054.
INSTANCED_T_TOL = 2e-4
INSTANCED_EDGE = 1e-4
INSTANCED_EDGE_RATE = 1e-3
# The path-traced production frame (phase 21): the benchmark's
# configuration PT_CONFIG (BASELINE config #5; its materials, lights,
# camera and render settings) on the heightfield
# displaced_grid_mesh(PT_MESH), at a PT_SIDE^2 frame (8 queries of
# PT_SIDE^2 rays at its 4 bounces), timed over PT_SEEDS after one warm-up
# frame; PT_BATCHES frames in one batch; the bounce (0-based) whose
# closest query is sampled against the oracle, PT_ORACLE rays of it.
PT_CONFIG = "cardbench/configs/heightfield-1m-pt.json"
PT_MESH = 707
PT_SIDE = 1024
PT_SEEDS = (0, 1, 2)
PT_BATCHES = (2, 4)
PT_ORACLE_BOUNCE = 2
PT_ORACLE = 4096
# Sampled bounce rays may differ from the oracle in hit mask only within
# PT_EDGE (float64 barycentric margin) of a winner's edge (ROADMAP F1),
# at most PT_EDGE_FLIPS in each direction.
PT_EDGE = 1e-4
PT_EDGE_FLIPS = 8
# The consumers on the card against the CPU (phase 22): the room renders
# at CONSUMER_SIDE (64 x 48), the path-traced room at 32 x 24 with 3
# bounces, the grid frame on displaced_grid_mesh(CONSUMER_GRID[0]) at
# C = CONSUMER_GRID[1] and CONSUMER_GRID[2] x CONSUMER_GRID[3] pixels.
CONSUMER_SIDE = (64, 48)
CONSUMER_PT = (32, 24, 3)
CONSUMER_GRID = (128, 128, 256, 192)
CONSUMER_PARTICLES = 1024
# The rounds engine (phase 23) reports t from the featurized test, not from
# the exact recompute, so against the regrouped engine and the oracle its
# t agrees within the engine contract's rtol 2e-5, and a differing winner
# must be a t tie within that bound. Its any_hit may differ from the
# regrouped any_hit on at most ANY_FLIPS_MAX of the 1M shadow rays, each
# at an edge (an occluder the exact test rejects at slack 1e-4) or within
# NEAR_SURFACE_T of the origin.
ROUNDS_TIE = 2e-5
ANY_FLIPS_MAX = 16
# BVH4 (phase 24): every BVH4_STRIDE-th headline ray (65,536), a cut: the
# traversals run at a few hundredths of a Mray/s.
BVH4_STRIDE = 16
# The classifier (phase 26): headline tiles of 2048 rays drawn with a seed.
CLASSIFIER_TILES = 32
# Sharding (phase 27): gloo ranks on the one card and the limit on their
# subprocess.
SHARD_RANKS = 2
SHARD_TIMEOUT_S = 300
# The card probes' sizes, the tools' defaults: P1's table rows and steps,
# P2's TILE and blocks, P4's blocks.
GATHER_SHAPE = (8192, 2048)
# Table rows at which phase 15 times P1's loop and take in both tiers, the
# measurement behind gather_probe.SLICE_ROWS.
GATHER_SWEEP = (16, 1024, 2048, 4096, 5120, 6144, 7168, 8192, 10432)
EPILOGUE_SHAPE = (512, 8192)
PROBE_BLOCKS = 8192
# Tiles of each worklist cell (phases 8-11) that K3 and K4 are held to
# their kernel-order model on, with all their blocks.
SAMPLE_TILES = 16
# Blocks of each regrouped or packed sweep (phases 5, 11-13) that K2 and
# K5 are held to their kernel-order model on.
SAMPLE_BLOCKS = 64


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


def graph_ms(fn, reps, calls=50):
    """Median device time of one call of ``fn`` in ms over ``reps``
    replays of a CUDA graph of ``calls`` calls: the host's time to launch
    each call, which can exceed a short kernel's, drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def worklist_tie_rtol(bits):
    """Relative t tie bound of the tile worklist: its keys keep 23 - bits
    mantissa bits of t, so two hits within 2^-(23 - bits) relative tie on
    the key and the smaller lane wins; the exact finalize then reports
    that triangle's own t. Plus the 2e-6 of the engine contract."""
    return 2.0 ** -(23 - bits) + 2e-6


def check_hits(ref, got, what, edge=None, max_only_ref=0, max_only_got=0,
               tie=2e-6):
    """The parity contract of the JAX package's engine tests: equal hit
    masks; t within rtol max(2e-5, tie) / atol 2e-6 where both hit; a
    differing prim only as a t tie below ``tie`` relative (2e-6, or
    ``worklist_tie_rtol`` for the worklist). Hit masks may differ only on
    the rows flagged by ``edge``: at most ``max_only_ref`` rows where only
    ref hits and ``max_only_got`` where only got hits. Returns (rows where
    both hit, prim ties, rows where only ref hits, rows where only got
    hits)."""
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
    np.testing.assert_allclose(gt, rt, rtol=max(2e-5, tie), atol=2e-6,
                               err_msg=what)
    pm = ref.prim_idx.cpu().numpy()[both] == got.prim_idx.cpu().numpy()[both]
    if not pm.all():
        rel = np.abs(gt[~pm] - rt[~pm]) / np.maximum(rt[~pm], 1e-6)
        if rel.max() >= tie:
            raise AssertionError(f"{what}: differing prim without a t tie "
                                 f"(rel {rel.max():.3g} >= {tie:.3g})")
    return int(both.sum()), int((~pm).sum()), only_ref, only_got


def compare_sweeps(what, kk, pk, kp, pp, bits):
    """A closest-hit sweep kernel's (key, pair) against its plain
    version's: hit-mask flips (pair >= 0) on at most 1e-5 of the rows,
    decoded t within rtol 2e-6 where both hit (the dot's summation order
    differs), and equal pairs wherever the keys are equal. Returns (rows,
    plain hits, flips, pair differences, max abs and max rel t error)."""
    hk, hp = pk >= 0, pp >= 0
    rows = kk.numel()
    flips = int((hk != hp).sum())
    both = hk & hp
    mask = (1 << bits) - 1
    tk = (kk[both] & ~mask).view(torch.float32)
    tp = (kp[both] & ~mask).view(torch.float32)
    err = float((tk - tp).abs().max()) if both.any() else 0.0
    rel = float(((tk - tp).abs() / tp.abs().clamp_min(1e-6)).max()) \
        if both.any() else 0.0
    same_key = both & (kk == kp)
    pair_diff = int((pk[both] != pp[both]).sum())
    tie_diff = int((pk[same_key] != pp[same_key]).sum())
    if flips > 1e-5 * rows:
        raise AssertionError(f"{what}: {flips} hit-mask flips > 1e-5 of "
                             f"{rows}")
    if rel > 2e-6:
        raise AssertionError(f"{what}: decoded t differs by rel {rel:.3g} "
                             f"> 2e-6")
    if tie_diff:
        raise AssertionError(f"{what}: {tie_diff} rows with equal keys name "
                             f"different triangles")
    return rows, int(hp.sum()), flips, pair_diff, err, rel


def bound(n_bytes, flops, peak=PEAK_FP32_FLOPS):
    """(ms, what bounds it): the least time the card could take to move
    ``n_bytes`` and do ``flops`` operations at ``peak`` (float32 outside
    the tensor cores unless given)."""
    by_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    by_ops = flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def table_bytes(cids, C):
    """Bytes of the feature table a sweep must read once: the 19 C nonzero
    float32 coefficients of each distinct cluster's (16, 4C) table."""
    return int(torch.unique(cids).numel()) * 19 * C * 4


def shadow_rays(rt, res, o, d, light):
    """A renderer's shadow pass: from each hit point, lifted SHADOW_LIFT
    along the hit triangle's face normal (turned toward the light), one
    ray toward the light with t_max = inf. A ray that missed keeps its
    origin, above the scene."""
    v = res.triangle.vertices
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / n.norm(dim=1, keepdim=True).clamp_min(1e-30)
    n = torch.where((n * light).sum(1, keepdim=True) < 0, -n, n)
    hit = res.hit[:, None]
    so = torch.where(hit, o + res.t[:, None] * d + SHADOW_LIFT * n, o)
    return rt.Ray.create(so, light.expand_as(so).contiguous())


def occluder_t(prims, res, rays, eps=1e-4):
    """Scalar Möller–Trumbore in float64 on each reported occluder:
    (genuine, t, u, v) where genuine means u, v >= -eps, u + v <= 1 + eps
    and 0 <= t <= t_max within eps (with eps = 1e-4 as in
    tests/test_pallas_dense.py:145-163); rows without an occluder are
    genuine with t = inf."""
    m = res.hit
    v = prims.vertices[res.prim_idx.clamp_min(0)].double()
    o, d = rays.o.double(), rays.d.double()
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    s1 = torch.linalg.cross(d, e2)
    r = 1.0 / (s1 * e1).sum(1)
    dv = o - v[:, 0]
    u = (dv * s1).sum(1) * r
    s2 = torch.linalg.cross(dv, e1)
    vv = (d * s2).sum(1) * r
    t = (e2 * s2).sum(1) * r
    ok = (u >= -eps) & (vv >= -eps) & (u + vv <= 1 + eps) & (t >= -eps) \
        & (t <= rays.t_max.double() * (1 + eps))
    return ok | ~m, torch.where(m, t, float("inf")), u, vv


def occlusion_tests(ops_dense, tids, cids, pair, TILE, C, K):
    """Featurized tests K4 needs on this data: a free ray tests every lane
    of every block of its tile; an occluded ray those of the blocks before
    its occluder's block, then lanes up to and including the occluder."""
    R = pair.numel()
    n_tiles = R // TILE
    dev = pair.device
    start = ops_dense.tile_ranges(tids, n_tiles).long()
    per_tile = start[1:] - start[:-1]
    pos = torch.zeros((n_tiles, K), dtype=torch.long, device=dev)
    t, c = tids.long(), cids.long()
    pos[t, c] = torch.arange(t.numel(), device=dev) - start[t]
    tile = torch.arange(R, device=dev) // TILE
    p = pair.long().clamp_min(0)
    tests = torch.where(pair >= 0, pos[tile, p // C] * C + p % C + 1,
                        per_tile[tile] * C)
    return int(tests.sum())


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
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    import raycore_tpu_torch as rt
    from raycore_tpu_torch.accel import dispatch
    from raycore_tpu_torch.kernels import _build
    from raycore_tpu_torch.ops import affine as ops_affine
    from raycore_tpu_torch.ops import brute as ops_brute
    from raycore_tpu_torch.ops import dense as ops_dense
    from raycore_tpu_torch.ops import regroup as ops_regroup
    from raycore_tpu_torch.tools import epilogue_experiments as p2
    from raycore_tpu_torch.tools import gather_probe as p1
    from raycore_tpu_torch.tools import probe_block_overhead as p4
    from raycore_tpu_torch.tools import probe_matmul_shapes as p3

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
    mesh = rt.displaced_grid_mesh(**HEADLINE_MESH, device=dev)

    def build():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = rt.build_dense(mesh, cluster_size=HEADLINE_C)
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
    po, pd, ptmin, ptmax, R0, G, TILE = ops_regroup._swept_batch(
        rays, 2048, 32)[:7]
    SPB = 16

    # 4. K1 against its plain version, bitwise.
    stats, bounds, ek, k1_err, k1_slow = phase_a_check(
        "K1 headline", ops_dense, scene, (po, pd, ptmin, ptmax), TILE)
    # K1 is shorter than the host's time to launch it through its
    # wrapper, so its time on the card comes from a CUDA graph of 50
    # calls; the wrapper's time a call, launched from the host back to
    # back, is printed beside it.
    k1_ms = graph_ms(lambda: ops_dense.phase_a(stats, bounds), 5)
    k1_host_ms = cuda_ms(lambda: ops_dense.phase_a(stats, bounds), 5,
                         inner=50)
    k1_plain_ms = cuda_ms(lambda: ops_dense.phase_a_plain(stats, bounds), 5,
                          inner=10)
    # The launch floor: an empty kernel on K1's grid, timed as K1 is.
    lib = _build.library()
    grid = ops_dense.phase_a_grid(stats.shape[0], bounds.shape[1])
    empty_ms = graph_ms(lambda: _build.check(lib.raycore_empty_launch(
        *grid, ops_dense.PHASE_A_THREADS, _build.stream_ptr(stats)),
        "empty_launch"), 5)
    k1_bound = bound(nbytes(stats, bounds, ek), ek.numel() * K1_PAIR_FLOPS)
    k1_ops_ms = ek.numel() * K1_PAIR_FLOPS / PEAK_FP32_FLOPS * 1e3
    say(4, f"K1 phase_a {tuple(ek.shape)}: bitwise equal to plain and to "
           f"phase_a_model, {int(torch.isfinite(ek).sum())} finite pairs, "
           f"{k1_slow} on the plain arithmetic; "
           f"kernel {k1_ms:.4f} ms on the card ({k1_host_ms:.4f} ms a call "
           f"launched from the host), plain {k1_plain_ms:.4f} ms; an empty "
           f"launch on its grid {grid} {empty_ms:.4f} ms; bound "
           f"{k1_bound[0]:.4f} ms ({k1_bound[1]}; operations "
           f"{k1_ops_ms:.4f} ms at {K1_PAIR_FLOPS} a pair)")

    # 5. K2 against its plain version on the headline blocks.
    k2 = regroup_sweep_check("K2 headline", ops_regroup, scene,
                             (po, pd, ptmin, ptmax), TILE, G, SPB, 5)
    n_blocks, k2_err = k2["blocks"], k2["err"]
    say(5, k2["desc"])
    k2_ms = cuda_ms(k2["run"], 10)
    k2_plain_ms = cuda_ms(k2["run_plain"], 3)
    k2_bound = k2["bound"]
    say(5, f"K2 kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms bound "
           f"{k2_bound[0]:.3f} ms ({k2_bound[1]})")
    # K5 computes K2's function at one sub-chunk per cluster: on K2's own
    # blocks, one sub-block of SPB subgroups per CTA, it must give K2's
    # bits; its time beside K2's says whether one kernel could serve both.
    k5_as_k2 = lambda: ops_regroup.run_packed(
        *k2["args"], G=G, SPB_sub=SPB, PACKS=1, C_eff=scene.cluster_size,
        SUBC=1)
    for got, want, name in zip(k5_as_k2(), k2["out"], ("key", "pair")):
        if not torch.equal(got, want):
            raise AssertionError(f"K5 at PACKS=1 on K2's blocks: "
                                 f"{int((got != want).sum())} {name}s differ "
                                 f"from K2's")
    # Interleaved: K2, K5, K5, K2.
    t_k2a, t_k5a, t_k5b, t_k2b = (cuda_ms(f, 10) for f in (
        k2["run"], k5_as_k2, k5_as_k2, k2["run"]))
    say(5, f"K5 packed_sweep on K2's blocks (SUBC 1, C_eff {scene.cluster_size}"
           f", SPB_sub {SPB}, PACKS 1): bitwise equal to K2; K2 {t_k2a:.3f} / "
           f"{t_k2b:.3f} ms, K5 {t_k5a:.3f} / {t_k5b:.3f} ms")
    del k2

    counters = {"phase_a": ops_dense.phase_a,
                "refine_pairs": ops_regroup.refine_pairs,
                "instance_refresh": ops_affine.refresh_tables,
                "local_rays": ops_affine.local_rays,
                "regroup_sweep": ops_regroup.run_regrouped,
                "worklist_sweep": ops_dense.run_worklist,
                "occlusion_sweep": ops_dense.run_occlusion,
                "packed_sweep": ops_regroup.run_packed,
                "brute_sweep": ops_brute.run_brute,
                "gather_probe": p1.run_gather,
                "epilogue_probe": p2.run_epilogue,
                "matmul_probe": p3.run_matmul,
                "block_probe": p4.run_block}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
            for v in getattr(fn, "by_variant", ()):
                fn.by_variant[v] = 0

    def read_counts(what, want):
        """The launch counts since zero_counts(): every kernel in ``want``
        must have launched and no other."""
        got = {k: fn.launches for k, fn in counters.items()}
        if any((got[k] > 0) != (k in want) for k in got):
            raise AssertionError(f"{what}: launches {got}, expected {want} "
                                 f"> 0 and every other kernel 0")
        return got

    # 6. The headline query through the public entry point.
    zero_counts()
    res = rt.closest_hit(scene, rays)                 # warm-up
    torch.cuda.synchronize()
    walls = []

    def query():
        nonlocal res
        t = time.perf_counter()
        res = rt.closest_hit(scene, rays)
        walls.append(time.perf_counter() - t)

    q_ms = cuda_ms(query, 5)
    launches = read_counts("headline closest_hit",
                           ["phase_a", "refine_pairs", "regroup_sweep"])
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
           f"{launches}; n_blocks {n_blocks}; depth_layers "
           f"{rt.depth_layers(scene)}, dispatch passes "
           f"{ops_regroup.resolve_passes(scene, dispatch.BIG_BATCH_PASSES)}"
           )
    # bench.py reports hit_frac to 4 places.
    if round(hit_frac, 4) != 1.0 or off_diag_misses:
        raise AssertionError(f"hit_frac {hit_frac}, {off_diag_misses} misses "
                             f"off the x == y line")
    if res.t.shape != (R0,) or not bool(torch.isfinite(res.t).all()):
        raise AssertionError("headline t is not finite or has the wrong "
                             "shape")
    passes_phase(6, ops_regroup, scene, rays, res, (1, 4), 5)

    # 7. Oracle on a seeded sample of the headline rays plus every ray on
    # the x == y line. Hit masks may differ only on that line, where
    # neither test is watertight.
    rng = np.random.default_rng(SEED)
    oracle_sample_phase(7, rt, scene, o, d, res, diag, 2e-6, rng)
    # A light 45 degrees up. The heightfield's slopes stay below 2, so a
    # steeper light (0.4, 0.3, 1.0) shadows no point of it and would leave
    # the occlusion checks without an occluded ray.
    light = torch.tensor([0.4, 0.3, 0.5], device=dev)
    light = light / light.norm()
    shadow_1m = shadow_rays(rt, res, o, d, light)
    # Phases 12 and 13 hold the packed engine against this result.
    head = (res.hit.clone(), res.t.clone(), res.prim_idx.clone())
    del res

    # 8. Depth-complex scene with incoherent rays: dispatch sends its
    # 262,144 rays to the tile worklist.
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
    zero_counts()
    t = time.perf_counter()
    bres = rt.closest_hit(bscene, brays)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t) * 1e3
    b_launches = read_counts("blobby closest_hit",
                             ["phase_a", "worklist_sweep"])
    bidx = torch.as_tensor(rng.choice(Rb, 4096, replace=False), device=dev)
    bref = rt.closest_hit_brute(bscene.prims, rt.Ray.create(
        brays.o[bidx], brays.d[bidx]))
    bbits = ops_dense._idx_bits(bscene.cluster_size)
    n_hit, n_tie, _, _ = check_hits(bref, bres.map(lambda a: a[bidx]),
                                    "blobby", tie=worklist_tie_rtol(bbits))
    # The worklist's worst case: the plain sweep takes seconds here, so it
    # is timed once.
    b_blocks = worklist_sweep_phase(8, ops_dense, bscene, brays,
                                    plain_reps=1)["blocks"]
    bw_ms = cuda_ms(lambda: rt.closest_hit(bscene, brays), 3)
    rg = lambda: ops_regroup.closest_hit_regrouped(bscene, brays, tile=2048,
                                                   passes=1)
    rres = rg()                                       # warm-up
    br_ms = cuda_ms(rg, 3)
    check_hits(bres, rres, "blobby worklist vs regrouped",
               tie=worklist_tie_rtol(bbits))
    say(8, f"blobby {blob.vertices.shape[0]} tris x {Rb} incoherent rays: "
           f"hit_frac {float(bres.hit.float().mean()):.4f}, first query "
           f"{b_ms:.1f} ms, launches {b_launches}; sample vs oracle: "
           f"{n_hit}/{bidx.numel()} hits agree, {n_tie} prim ties; steady "
           f"state (median of 3 after a warm-up): worklist {bw_ms:.2f} ms "
           f"({bscene.n_clusters} clusters, {b_blocks} K3 blocks), regrouped "
           f"{br_ms:.2f} ms")
    del bscene, blob, brays, bres, bref, rres

    # 9. closest_hit below REGROUP_MIN_RAYS: the 512^2 primary pass goes to
    # the tile worklist (K1 and K3).
    o5, d5 = morton_grid_rays(512, dev)
    rays5 = rt.Ray.create(o5, d5)
    R5 = o5.shape[0]
    zero_counts()
    res5 = rt.closest_hit(scene, rays5)
    torch.cuda.synchronize()
    launches5 = read_counts("512^2 closest_hit",
                            ["phase_a", "worklist_sweep"])
    k3 = worklist_sweep_phase(9, ops_dense, scene, rays5)
    w_ms = cuda_ms(lambda: rt.closest_hit(scene, rays5), 5)
    diag5 = o5[:, 0] == o5[:, 1]
    off_diag5 = int((~res5.hit & ~diag5).sum())
    say(9, f"closest_hit {R5} rays (worklist): {w_ms:.3f} ms median of 5 "
           f"({R5 / w_ms / 1e3:.3f} Mrays/s), {k3['blocks']} blocks; "
           f"hit_frac {float(res5.hit.float().mean())} "
           f"({int((~res5.hit).sum())} misses, {off_diag5} off the x == y "
           f"line); launches {launches5}")
    if off_diag5:
        raise AssertionError(f"512^2: {off_diag5} misses off the x == y line")
    oracle_sample_phase(9, rt, scene, o5, d5, res5, diag5,
                        worklist_tie_rtol(k3["bits"]),
                        np.random.default_rng(SEED + 9))

    # 10. The worklist on the headline mesh with sub_chunks=4.
    scene4 = rt.build_dense(mesh, cluster_size=256, sub_chunks=4)
    zero_counts()
    res4 = rt.closest_hit(scene4, rays5)
    torch.cuda.synchronize()
    launches4 = read_counts("sub_chunks=4 closest_hit",
                            ["phase_a", "worklist_sweep"])
    k3s = worklist_sweep_phase(10, ops_dense, scene4, rays5)
    w4_ms = cuda_ms(lambda: rt.closest_hit(scene4, rays5), 5)
    say(10, f"closest_hit {R5} rays, sub_chunks=4: {w4_ms:.3f} ms median of "
            f"5 ({R5 / w4_ms / 1e3:.3f} Mrays/s), {k3s['blocks']} blocks; "
            f"launches {launches4}")
    oracle_sample_phase(10, rt, scene4, o5, d5, res4, diag5,
                        worklist_tie_rtol(k3s["bits"]),
                        np.random.default_rng(SEED + 10))
    del res4

    # 11. Shadow rays toward a light from the 512^2 and 1024^2 hit points.
    shadow_5 = shadow_rays(rt, res5, o5, d5, light)
    del res5
    # Each pass holds the sweep kernel it launched against its plain
    # version on its own operands: K4 on the worklist any_hit builds, K2 on
    # the regrouped blocks of the same rays with t_min forced to 0.
    k4 = None
    for name, srays, want in (
            ("512^2", shadow_5, ["phase_a", "occlusion_sweep"]),
            ("1024^2", shadow_1m, ["phase_a", "refine_pairs",
                                   "regroup_sweep"])):
        zero_counts()
        occ = rt.any_hit(scene, srays)
        torch.cuda.synchronize()
        counts = read_counts(f"{name} any_hit", want)
        a_ms = cuda_ms(lambda: rt.any_hit(scene, srays), 5)
        if counts["occlusion_sweep"]:
            k4 = occlusion_sweep_phase(ops_dense, scene, srays)
            k4["launches"] = counts["occlusion_sweep"]
            sweep_desc = (
                f"K1 bitwise equal to plain; K4 on its worklist "
                f"({k4['blocks']} blocks): {k4['diff']} "
                f"occluder differences from plain, kernel {k4['ms']:.3f} ms "
                f"plain {k4['plain_ms']:.3f} ms bound {k4['bound'][0]:.4f} "
                f"ms ({k4['bound'][1]})")
        else:
            sweep_desc = regroup_occlusion_check(ops_dense, ops_regroup, rt,
                                                 scene, srays)
        genuine, t_occ, u, v = occluder_t(scene.prims, occ, srays)
        near_edge = occluder_t(scene.prims, occ, srays,
                               EDGE_ROUNDING_SLACK)[0]
        nr = srays.o.shape[0]
        fake = ~genuine
        n_fake = int(fake.sum())
        unexplained = int((fake & ~near_edge).sum())
        fake_desc = "; ".join(
            f"t {float(t_occ[i]):.4g} u {float(u[i]):.6g} "
            f"v {float(v[i]):.6g}"
            for i in torch.nonzero(fake).squeeze(1)[:4].tolist())
        if unexplained or n_fake > FAKE_OCCLUDERS_MAX:
            raise AssertionError(
                f"{name} any_hit: {n_fake} occluders the exact test rejects "
                f"at slack 1e-4 ({unexplained} also at slack "
                f"{EDGE_ROUNDING_SLACK}, none allowed; at most "
                f"{FAKE_OCCLUDERS_MAX} in all): {fake_desc}")
        n_flip, n_near = shadow_oracle(rt, scene, srays, occ, t_occ,
                                       np.random.default_rng(SEED + 11))
        say(11, f"any_hit {nr} shadow rays ({name}): occluded fraction "
                f"{float(occ.hit.float().mean()):.6f}, {a_ms:.3f} ms median "
                f"of 5 ({nr / a_ms / 1e3:.3f} Mrays/s), launches {counts}; "
                f"{sweep_desc}; {n_fake} occluders the exact test rejects "
                f"at slack 1e-4, each within {EDGE_ROUNDING_SLACK} of the "
                f"triangle (at most {FAKE_OCCLUDERS_MAX}; "
                f"{fake_desc or 'none'}); sample vs oracle: {n_flip} hit "
                f"differences, all near the surface ({n_near} near-surface "
                f"rays; at most {NEAR_SURFACE_FLIPS_MAX})")

    # 12. The packed engine on the headline rays: the headline mesh built
    # with sub_chunks=4 (C_eff = 64), which dispatch sends to
    # closest_hit_packed (K1 and K5).
    zero_counts()
    res_p = rt.closest_hit(scene4, rays)
    torch.cuda.synchronize()
    launches_p = read_counts("packed closest_hit",
                             ["phase_a", "refine_pairs", "packed_sweep"])
    k5 = packed_phase(12, rt, ops_dense, ops_regroup, scene4, rays,
                      lambda: rt.closest_hit(scene4, rays), res_p, head,
                      diag, launches_p)
    oracle_sample_phase(12, rt, scene4, o, d, res_p, diag, 2e-6,
                        np.random.default_rng(SEED + 12))
    del scene4, res_p

    # 13. The packed engine at cluster granularity (C_eff = C = 256): its
    # 19 KB sub-cluster slices, staged in four lane chunks.
    zero_counts()
    res_c = ops_regroup.closest_hit_packed(scene, rays)
    torch.cuda.synchronize()
    launches_c = read_counts("packed closest_hit, sub_chunks=1",
                             ["phase_a", "refine_pairs", "packed_sweep"])
    packed_phase(13, rt, ops_dense, ops_regroup, scene, rays,
                 lambda: ops_regroup.closest_hit_packed(scene, rays), res_c,
                 head, diag, launches_c)
    del res_c

    # 14. The dense brute-force sweep (K6) on a 65,024-triangle sphere, the
    # scale ops/pallas_brute.py names ("meshes up to ~64K triangles").
    k6 = brute_phase(14, rt, ops_brute, dev, read_counts, zero_counts)

    # 15-18. The card probes, each through its tool's entry point.
    probes = [*gather_phase(15, p1, dev, read_counts, zero_counts),
              epilogue_phase(16, p2, dev, read_counts, zero_counts),
              matmul_phase(17, p3, dev, read_counts, zero_counts),
              block_phase(18, p4, dev, read_counts, zero_counts,
                          k2_ms / n_blocks * 1e3)]

    # 19. The blobby 1M cell: the ordered multiwave.
    k2m = multiwave_phase(19, rt, ops_dense, ops_regroup, dispatch, dev,
                          read_counts, zero_counts)

    # 20. The 256-instance dynamic frame: K1 and K2's pairrow mode.
    k2i = instanced_phase(20, rt, ops_dense, ops_regroup, dev, read_counts,
                          zero_counts)

    # 21. The path-traced production frame: K1 and K2 on every query.
    frame = pathtracer_phase(21, rt, ops_dense, ops_regroup, dispatch, dev,
                             read_counts, zero_counts)

    # 22. The consumers on the card against their CPU twins.
    consumers_phase(22, rt, ops_dense, dispatch, dev, read_counts,
                    zero_counts)

    # 23. The rounds engine on the headline: K1 once a query.
    k1_rounds = rounds_phase(23, rt, ops_dense, scene, o, d, head, diag,
                             shadow_1m, read_counts, zero_counts)

    # 24. The BVH4 layer on the 1M heightfield.
    bvh4_phase(24, rt, mesh, o, d, diag)

    # 25. The accel protocol, the transport records and the IO.
    surface_phase(25, rt, dev, scene, mesh, rays)

    # 26. The two-phase classifier on the headline's candidates.
    classifier_phase(26, rt, scene, o, d)

    # 27. Ray sharding in gloo ranks on the one card.
    sharding_phase(27, rt, dev, o, d, head, diag)

    # 28. K7 on the 1M primary and the 1M two-light shadow queries.
    k7 = refine_phase(28, rt, ops_dense, ops_regroup, scene, [
        ("1M primary", rays, False),
        ("1M shadow, two lights", two_light_shadow_rays(rt, shadow_1m),
         True)], read_counts, zero_counts)

    # 29. K8 at the benchmark's refit frame's shapes.
    k8 = affine_phase(29, dev, read_counts, zero_counts)

    kernels = [
        {"name": "phase_a", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/phase_a.cu",
         "replaces": "raycore_tpu/ops/pallas_dense.py:445",
         "launches": launches["phase_a"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        k1_rounds,
        {"name": "regroup_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/regroup_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_regroup.py:191",
         "path": "headline, passes=1",
         "launches": launches["regroup_sweep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "regroup_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/regroup_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_regroup.py:191",
         "path": "blobby 1M, passes=4: wave grid + remainder grid",
         "launches": k2m["launches"], "max_abs_err": k2m["err"],
         "ms": k2m["ms"], "plain_ms": k2m["plain_ms"],
         "bound_ms": k2m["bound"][0], "bound_by": k2m["bound"][1],
         "library_ms": None},
        {"name": "regroup_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/regroup_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_regroup.py:191",
         "path": "256-instance frame, pairrow",
         "launches": k2i["launches"], "max_abs_err": k2i["err"],
         "ms": k2i["ms"], "plain_ms": k2i["plain_ms"],
         "bound_ms": k2i["bound"][0], "bound_by": k2i["bound"][1],
         "library_ms": None},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"raycore_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "path": "path-traced frame, its 8 queries",
         "launches": frame["launches"][name], "max_abs_err": k["err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
         "bound_by": k["bound"][1], "library_ms": None}
        for name, replaces, k in (
            ("phase_a", "raycore_tpu/ops/pallas_dense.py:445", frame["k1"]),
            ("regroup_sweep", "raycore_tpu/ops/pallas_regroup.py:191",
             frame["k2"]))
    ] + [
        {"name": "worklist_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/worklist_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_dense.py:116",
         "launches": launches5["worklist_sweep"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
         "library_ms": None},
        {"name": "occlusion_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/occlusion_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_dense.py:286",
         "launches": k4["launches"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound"][0], "bound_by": k4["bound"][1],
         "library_ms": None},
        {"name": "packed_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/packed_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_regroup.py:455",
         "launches": launches_p["packed_sweep"], "max_abs_err": k5["err"],
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound"][0], "bound_by": k5["bound"][1],
         "library_ms": None},
        {"name": "brute_sweep", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/brute_sweep.cu",
         "replaces": "raycore_tpu/ops/pallas_brute.py:34",
         "launches": k6["launches"], "max_abs_err": k6["err"],
         "ms": k6["ms"], "plain_ms": k6["plain_ms"],
         "bound_ms": k6["bound"][0], "bound_by": k6["bound"][1],
         "library_ms": None},
    ] + [
        {"name": "refine_pairs", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/refine_pairs.cu",
         "replaces": None, "path": k["path"], "launches": k["launches"],
         "max_abs_err": 0.0, "ms": k["ms"], "host_ms": k["host_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
         "bound_by": k["bound"][1], "library_ms": None} for k in k7
    ] + [
        {"name": "instance_affine", "route": "cuda",
         "source": "raycore_tpu_torch/csrc/instance_affine.cu",
         "replaces": None, "path": k["path"], "launches": k["launches"],
         "max_abs_err": 0.0, "ms": k["ms"], "host_ms": k["host_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
         "bound_by": k["bound"][1], "library_ms": None} for k in k8
    ] + [{"name": p["name"], "route": "cuda",
          "source": f"raycore_tpu_torch/csrc/{p['name']}.cu",
          "replaces": p["replaces"],
          **({"path": p["path"]} if p["path"] else {}),
          "launches": p["launches"],
          "max_abs_err": p["err"], "ms": p["ms"], "plain_ms": p["plain_ms"],
          "bound_ms": p["bound"][0], "bound_by": p["bound"][1],
          "library_ms": p["library_ms"],
          **({"products_bound_ms": p["products_bound"]}
             if p["products_bound"] is not None else {})} for p in probes]
    say("end", f"chip_smoke.py wall time "
               f"{time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def phase_a_check(what, ops_dense, scene, rows, TILE):
    """K1 against its plain version and its model, bitwise, on the phase-A
    operands a query builds from ``rows`` (o, d, t_min, t_max) padded to
    whole tiles of TILE rays. Returns (stats, bounds, entry, max abs error
    over the finite entries, pairs that take the plain arithmetic)."""
    from raycore_tpu_torch.accel.dense import INVD_COLS, ray_features
    o, d, t_min, t_max = ops_dense.pad_rays(*rows, TILE)
    stats, bounds = ops_dense.phase_a_inputs(
        o, ray_features(o, d)[:, INVD_COLS], t_min, t_max,
        scene.cluster_min, scene.cluster_max, TILE)
    ek = ops_dense.phase_a(stats, bounds)
    ep = ops_dense.phase_a_plain(stats, bounds)
    em, fast = ops_dense.phase_a_paths(stats, bounds)
    torch.cuda.synchronize()
    for ref, name in ((ep, "plain version"), (em, "model")):
        if not torch.equal(ek.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(
                f"{what}: {int((ek.view(torch.int32) != ref.view(torch.int32)).sum())}"
                f" of {ek.numel()} entries differ from the {name}")
    fin = torch.isfinite(ek)
    err = float((ek[fin] - ep[fin]).abs().max()) if fin.any() else 0.0
    return stats, bounds, ek, err, int((~fast).sum())


def sweep_check(what, stage1, kernel, plain, model, scene, rows, TILE, G,
                SPB, C_eff, phase):
    """``grid_check`` on the blocks ``stage1`` builds from ``rows``
    (padded to whole tiles) in blocks of SPB subgroups; the description
    names its pair counts."""
    block_cid, block_subs, tbl, counts = stage1(scene, *rows, TILE, G, SPB)
    pairs = ", ".join(f"{c} {w} pairs" for c, w in zip(
        counts[:-1], ("coarse", "subgroup", "sub-cluster")))
    return grid_check(what, kernel, plain, model, scene, block_cid,
                      block_subs, tbl, G, SPB, C_eff, phase, pairs)


def grid_check(what, kernel, plain, model, scene, block_cid, block_subs,
               tbl, G, SPB, C_eff, phase, pairs):
    """A closest-hit sweep kernel (K2 or K5) against its plain version on
    a block grid, within the stated tolerance, and bit for bit against
    its kernel-order model on sampled blocks (``block_model_check``); the
    bound of that sweep: each live row (a block with cid >= 0, a slot that
    is not the dummy subgroup) tests C_eff lanes, and the table read once
    is the 19 C_eff nonzero coefficients of each distinct (sub-)cluster's
    slice. ``kernel``, ``plain`` and ``model`` take (block_subs,
    block_cid, tbl, feats), ``model`` also ``blocks=``. Returns a dict:
    the kernel and its plain version on these blocks (``run``,
    ``run_plain``), the kernel's output and arguments, blocks, live rows,
    error, bound (and its bytes and operations) and a description."""
    args = (block_subs, block_cid, tbl, scene.tri_feats)
    kk, pk = kernel(*args)
    kp, pp = plain(*args)
    torch.cuda.synchronize()
    n, plain_hits, flips, pair_diff, err, rel = compare_sweeps(
        what, kk, pk, kp, pp, 0)
    n_sub = tbl.shape[0] - 1
    dummy = block_subs == n_sub
    live_rows = int(((block_cid >= 0)[:, None] & ~dummy).sum()) * G
    n_bytes = (nbytes(block_subs, block_cid, tbl, kk, pk)
               + table_bytes(block_cid, C_eff))
    flops = live_rows * C_eff * TEST_FLOPS
    b = bound(n_bytes, flops)
    model_desc = block_model_check(what, (kk, pk), lambda blocks: model(
        *args, blocks=blocks), dummy, G * SPB, phase)
    desc = (f"{what}: {block_cid.shape[0]} blocks ({pairs}; dummy subgroup "
            f"in {int(dummy.sum())} of {dummy.numel()} slots, "
            f"{float(dummy.float().mean()):.4f}), {n} rows, {live_rows} "
            f"live, {plain_hits} plain hits; hit-mask flips {flips}, pair "
            f"differences {pair_diff} (0 where the keys are equal), max rel "
            f"t {rel:.3g}; {model_desc}")
    return dict(run=lambda: kernel(*args), run_plain=lambda: plain(*args),
                out=(kk, pk), args=args, blocks=block_cid.shape[0],
                live_rows=live_rows, err=err, bound=b, bytes=n_bytes,
                flops=flops, desc=desc)


def block_model_check(what, got, model, dummy, ROWS, phase):
    """A closest-hit sweep kernel's (key, pair) ``got`` bit for bit
    against its kernel-order model ``model(blocks)`` on SAMPLE_BLOCKS
    blocks drawn with a seed plus the block with the most dummy slots
    (``dummy``: (n_blocks, SPB) bool). Returns a description."""
    n_blocks = dummy.shape[0]
    rng = np.random.default_rng(SEED + 200 + phase)
    pick = set(rng.choice(n_blocks, min(SAMPLE_BLOCKS, n_blocks),
                          replace=False).tolist())
    pick.add(int(dummy.sum(dim=1).argmax()))
    blocks = torch.tensor(sorted(pick), device=dummy.device)
    t = time.perf_counter()
    want = model(blocks)
    rows = blocks[:, None] * ROWS + torch.arange(ROWS, device=dummy.device)
    rows = rows.reshape(-1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    for g, w, name in zip(got, want, ("key", "pair")):
        n = int((g[rows] != w).sum())
        if n:
            raise AssertionError(f"{what}: {n} of {w.numel()} {name}s on "
                                 f"{blocks.numel()} sampled blocks differ "
                                 f"from the kernel-order model")
    return (f"bit for bit equal to the kernel-order model on "
            f"{blocks.numel()} sampled blocks ({int(dummy[blocks].sum())} "
            f"dummy slots, {int((want[1] >= 0).sum())} hits; the model took "
            f"{seconds:.2f} s)")


def regroup_sweep_check(what, ops_regroup, scene, rows, TILE, G, SPB,
                        phase):
    """K2 against its plain version and its kernel-order model on the
    regrouped stage 1's blocks."""
    C = scene.cluster_size
    kw = dict(G=G, SPB=SPB, C=C)
    return sweep_check(
        f"{what} regroup_sweep", ops_regroup._stage1_cm_core,
        lambda *a: ops_regroup.run_regrouped(*a, **kw),
        lambda *a: ops_regroup.run_regrouped_plain(*a, **kw),
        lambda *a, blocks: ops_regroup.run_regrouped_model(
            *a, **kw, blocks=blocks),
        scene, rows, TILE, G, SPB, C, phase)


def regroup_grid_check(what, ops_regroup, scene, block_cid, block_subs, tbl,
                       G, SPB, phase, pairs):
    """K2 against its plain version and its kernel-order model on a given
    block grid."""
    C = scene.cluster_size
    kw = dict(G=G, SPB=SPB, C=C)
    return grid_check(
        f"{what} regroup_sweep",
        lambda *a: ops_regroup.run_regrouped(*a, **kw),
        lambda *a: ops_regroup.run_regrouped_plain(*a, **kw),
        lambda *a, blocks: ops_regroup.run_regrouped_model(
            *a, **kw, blocks=blocks),
        scene, block_cid, block_subs, tbl, G, SPB, C, phase, pairs)


def regroup_occlusion_check(ops_dense, ops_regroup, rt, scene, rays):
    """The regrouped any_hit's kernels against their plain versions on its
    own operands: the rays with t_min forced to 0, padded to tile 2048, in
    the order the engine sweeps them (``ops/regroup.py:_swept_batch``)."""
    rays0 = rt.Ray.create(rays.o, rays.d, t_max=rays.t_max)
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._swept_batch(
        rays0, 2048, 32)[:7]
    rows = (po, pd, ptmin, ptmax)
    phase_a_check("K1 regrouped any_hit", ops_dense, scene, rows, TILE)
    k2 = regroup_sweep_check("K2 regrouped any_hit", ops_regroup, scene,
                             rows, TILE, G, 16, 11)
    return f"K1 bitwise equal to plain; {k2['desc']}"


def worklist_sweep_phase(phase, ops_dense, scene, rays, plain_reps=3,
                         tile=512, label=""):
    """K1 and K3 against their plain versions on a query's own operands
    (the query's ray tile ``tile``), K3 seeded from t_max; K3 bit for bit
    against its kernel-order model on sampled tiles; K3's times and its
    bound from the (block, sub-chunk) tests the plain version counts.
    Returns a dict of the numbers."""
    o, d, t_min, t_max = ops_dense.flat_rays(rays)
    TILE = ops_dense._tile_of(rays, tile)
    phase_a_check(f"K1 (phase {phase})", ops_dense, scene,
                  (o, d, t_min, t_max), TILE)
    tids, cids, phi, tmin, key0, _, _, _ = ops_dense._phase_a_and_worklist(
        scene, o, d, t_min, t_max, TILE=TILE)
    C, SUB = scene.cluster_size, scene.sub_chunks
    bits = ops_dense._idx_bits(C // SUB)
    args = (tids, cids, phi, scene.tri_feats, scene.sub_bounds, tmin, key0,
            torch.full_like(key0, -1))
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    kk, pk = ops_dense.run_worklist(*args, **kw)
    kp, pp, live = ops_dense.worklist_plain_live(*args, **kw)
    torch.cuda.synchronize()
    rows, plain_hits, flips, pair_diff, err, rel = compare_sweeps(
        f"K3 (sub_chunks={SUB})", kk, pk, kp, pp, bits)
    model = model_check(
        f"K3 (phase {phase})", ops_dense, tids, TILE, phase, (kk, pk),
        lambda tiles: ops_dense.run_worklist_model(*args, **kw, tiles=tiles))
    ms = cuda_ms(lambda: ops_dense.run_worklist(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: ops_dense.run_worklist_plain(*args, **kw),
                       plain_reps)
    # Each live (block, sub-chunk) pair tests TILE rays against C/SUB
    # lanes; with SUB > 1 every ray also runs a slab test per sub-chunk.
    n = cids.numel()
    b = bound(nbytes(*args[:3], tmin, key0, args[7], kk, pk)
              + table_bytes(cids, C)
              + (nbytes(scene.sub_bounds[torch.unique(cids.long())])
                 if SUB > 1 else 0),
              live * TILE * (C // SUB) * TEST_FLOPS
              + (n * SUB * TILE * SLAB_FLOPS if SUB > 1 else 0))
    skip = (f"; slab skip: {live} of {n * SUB} (block, sub-chunk) tests "
            f"live, {1 - live / (n * SUB):.4f} skipped" if SUB > 1 else "")
    say(phase, f"{label}K1 bitwise equal to plain; K3 worklist_sweep (TILE "
               f"{TILE}, C {C}, SUB {SUB}): {n} blocks, {rows} rows, {plain_hits} "
               f"plain hits; hit-mask flips {flips}, pair differences "
               f"{pair_diff} (0 where the keys are equal), max rel t "
               f"{rel:.3g}{skip}; {model}; kernel {ms:.3f} ms plain "
               f"{plain_ms:.3f} ms bound {b[0]:.4f} ms ({b[1]})")
    return dict(blocks=n, bits=bits, err=err, ms=ms, plain_ms=plain_ms,
                bound=b)


def model_check(what, ops_dense, tids, TILE, phase, got, model):
    """A sweep kernel's outputs ``got`` (a tensor or a tuple) bit for bit
    against its kernel-order model ``model(tiles)`` on SAMPLE_TILES tiles
    drawn with a seed (the tile with the most blocks among them), all
    their blocks. Returns a description."""
    got = got if isinstance(got, tuple) else (got,)
    n_tiles = got[0].numel() // TILE
    counts = torch.bincount(tids.long(), minlength=n_tiles)
    rng = np.random.default_rng(SEED + 100 + phase)
    pick = set(rng.choice(n_tiles, min(SAMPLE_TILES, n_tiles),
                          replace=False).tolist())
    pick.add(int(counts.argmax()))
    tiles = torch.tensor(sorted(pick), device=tids.device)
    want = model(tiles)
    want = want if isinstance(want, tuple) else (want,)
    rows = ops_dense.tile_rows(tiles, TILE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        n = int((g[rows] != w).sum())
        if n:
            raise AssertionError(f"{what}: {n} of {w.numel()} outputs on "
                                 f"{tiles.numel()} sampled tiles differ from "
                                 f"the kernel-order model")
    return (f"bit for bit equal to the kernel-order model on "
            f"{tiles.numel()} sampled tiles ({int(counts[tiles].sum())} "
            f"blocks, {rows.numel()} rays)")


def oracle_sample_phase(phase, rt, scene, o, d, res, diag, tie, rng):
    """A 4096-ray sample plus every ray on the x == y line against the
    oracle, with the relative t tie bound ``tie`` (2e-6 for the engines
    whose keys are full t bits, ``worklist_tie_rtol`` for the worklist);
    hit masks may differ only on the line, where neither test is
    watertight: at most DIAG_PORT_MISSES_MAX rays that only the oracle
    hits and DIAG_ORACLE_MISSES_MAX that only the port hits."""
    R = o.shape[0]
    pick = np.union1d(rng.choice(R, 4096, replace=False),
                      torch.nonzero(diag).squeeze(1).cpu().numpy())
    idx = torch.as_tensor(pick, device=o.device)
    ref = rt.closest_hit_brute(scene.prims, rt.Ray.create(o[idx], d[idx]))
    n_hit, n_tie, only_ref, only_port = check_hits(
        ref, res.map(lambda a: a[idx]), f"phase {phase}", edge=diag[idx],
        max_only_ref=DIAG_PORT_MISSES_MAX,
        max_only_got=DIAG_ORACLE_MISSES_MAX, tie=tie)
    say(phase, f"sample vs brute oracle: {idx.numel()} rays "
               f"({int(diag[idx].sum())} on the x == y line), tie bound "
               f"{tie:.3g} relative; {n_hit} hits agree, {n_tie} prim "
               f"ties; on the line {only_ref} hit only in the oracle (at "
               f"most {DIAG_PORT_MISSES_MAX}) and {only_port} only in the "
               f"port (at most {DIAG_ORACLE_MISSES_MAX})")


def occlusion_sweep_phase(ops_dense, scene, rays, phase=11, tile=512,
                          label=""):
    """K1 (bitwise) and K4 against their plain versions on the operands
    any_hit builds for ``rays`` at ray tile ``tile``: every occluder equal
    (at most 1e-5 of rows may differ); K4 bit for bit against its
    kernel-order model on sampled tiles; K4's tests per warp; K4's times
    and a bound from the tests this data needs."""
    o, d, t_min, t_max = ops_dense.flat_rays(rays)
    TILE = ops_dense._tile_of(rays, tile)
    phase_a_check("K1 worklist any_hit", ops_dense, scene,
                  (o, d, torch.zeros_like(t_min), t_max), TILE)
    tids, cids, phi, tmin, tmax = ops_dense._occl_phase_a(
        scene, o, d, torch.zeros_like(t_min), t_max, TILE=TILE)
    C, SUB = scene.cluster_size, scene.sub_chunks
    args = (tids, cids, phi, scene.tri_feats, tmin, tmax)
    kw = dict(TILE=TILE, C=C, SUB=SUB)
    pk = ops_dense.run_occlusion(*args, **kw)
    pp = ops_dense.run_occlusion_plain(*args, **kw)
    torch.cuda.synchronize()
    diff = int((pk != pp).sum())
    if diff > 1e-5 * pk.numel():
        raise AssertionError(f"K4: {diff} occluders differ from the plain "
                             f"version (> 1e-5 of {pk.numel()} rows)")
    model = model_check(
        f"K4 (phase {phase})", ops_dense, tids, TILE, phase, pk,
        lambda tiles: ops_dense.run_occlusion_model(*args, **kw,
                                                    tiles=tiles))
    ms = cuda_ms(lambda: ops_dense.run_occlusion(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: ops_dense.run_occlusion_plain(*args, **kw), 3)
    tests = occlusion_tests(ops_dense, tids, cids, pp, TILE, C,
                            scene.n_clusters)
    W = 32   # one ray a thread
    group_tests, warp_tests = occlusion_warp_tests(
        ops_dense, tids, cids, pk, TILE, C, scene.n_clusters, W)
    say(phase, f"{label}K1 bitwise equal to plain; K4 {model}; tests on "
               f"this data: {tests} that the rays need, {group_tests} in "
               f"whole lane groups of 4, {warp_tests} that warps of {W} "
               f"rays run ({1 - group_tests / warp_tests:.4f} of them for "
               f"rays already done)")
    b = bound(nbytes(*args[:3], tmin, tmax, pk) + table_bytes(cids, C),
              tests * TEST_FLOPS)
    # An occluder id is right or wrong: the error of a row is 1 where the
    # kernel's id differs from the plain version's, else 0.
    return dict(blocks=cids.numel(), diff=diff, err=float(diff > 0), ms=ms,
                plain_ms=plain_ms, bound=b, tests=tests,
                group_tests=group_tests, warp_tests=warp_tests)


def occlusion_warp_tests(ops_dense, tids, cids, pair, TILE, C, K, W):
    """K4's tests on this data as its warps run them. Per block, a ray
    tests lane groups of 4 until the group of its first accepted lane (all
    C / 4 groups while it stays free, none once it is occluded); a warp of
    W rays runs as many groups as its busiest ray, and each of its rays
    pays for them. Returns (the rays' tests in whole groups, the warps'
    tests)."""
    R = pair.numel()
    n_tiles = R // TILE
    dev = pair.device
    start = ops_dense.tile_ranges(tids, n_tiles).long()
    t, c = tids.long(), cids.long()
    j = torch.arange(t.numel(), device=dev) - start[t]
    pos = torch.zeros((n_tiles, K), dtype=torch.long, device=dev)
    pos[t, c] = j
    tile = torch.arange(R, device=dev) // TILE
    p = pair.long()
    occ_pos = torch.where(p >= 0, pos[tile, p.clamp_min(0) // C], t.numel())
    occ_groups = (p.clamp_min(0) % C) // 4 + 1
    rows = t[:, None] * TILE + torch.arange(TILE, device=dev)
    op = occ_pos[rows]
    need = torch.where(j[:, None] < op, C // 4,
                       torch.where(j[:, None] == op, occ_groups[rows], 0))
    need = torch.nn.functional.pad(need, (0, (-TILE) % W))
    warp = need.reshape(need.shape[0], -1, W).amax(dim=2)
    return int(need.sum()) * 4, int(warp.sum()) * 4 * W


def packed_phase(phase, rt, ops_dense, ops_regroup, scene, rays, query, res,
                 head, diag, launches):
    """The packed engine's query ``query`` (result ``res``) on the
    headline rays: K1 bitwise and K5 against their plain versions on the
    query's own operands; the query's median time, K5's and its plain
    version's, K5's bound; no miss off the x == y line; and the regrouped
    headline result ``head`` (hit, t, prim) ray for ray: equal hit masks,
    t within 2e-6 relative, a differing prim only as such a tie. Returns a
    dict of K5's numbers."""
    po, pd, ptmin, ptmax, R0, G, TILE = ops_regroup._padded_batch(
        rays, 2048, 32)
    rows = (po, pd, ptmin, ptmax)
    phase_a_check(f"K1 (phase {phase})", ops_dense, scene, rows, TILE)
    SPB_sub, PACKS, SUBC = 2, 8, scene.sub_chunks
    C_eff = scene.cluster_size // SUBC
    kw = dict(G=G, SPB_sub=SPB_sub, C_eff=C_eff, SUBC=SUBC)
    k5 = sweep_check(
        f"K5 packed_sweep (SUBC {SUBC}, C_eff {C_eff}, SPB_sub {SPB_sub}, "
        f"PACKS {PACKS})", ops_regroup._stage1_packed_core,
        lambda *a: ops_regroup.run_packed(*a, PACKS=PACKS, **kw),
        lambda *a: ops_regroup.run_packed_plain(*a, **kw),
        lambda *a, blocks: ops_regroup.run_packed_model(*a, **kw,
                                                        blocks=blocks),
        scene, rows, TILE, G, SPB_sub, C_eff, phase)
    ms = cuda_ms(k5["run"], 10)
    plain_ms = cuda_ms(k5["run_plain"], 3)
    b = k5["bound"]
    if C_eff > ops_regroup.LANE_CHUNK:
        # The slice staged in LANE_CHUNK-lane chunks (launched) against
        # staged whole, in turns: chunked, whole, whole, chunked.
        whole = lambda: ops_regroup.run_packed(*k5["args"], PACKS=PACKS,
                                               lane_chunk=C_eff, **kw)
        for got, want, name in zip(whole(), k5["out"], ("key", "pair")):
            if not torch.equal(got, want):
                raise AssertionError(f"K5 with whole slices: "
                                     f"{int((got != want).sum())} {name}s "
                                     f"differ from the chunked launch")
        t = [cuda_ms(f, 10) for f in (k5["run"], whole, whole, k5["run"])]
        say(phase, f"K5 slice staging at C_eff {C_eff}, PACKS {PACKS}: "
                   f"{ops_regroup.LANE_CHUNK}-lane chunks {t[0]:.3f} / "
                   f"{t[3]:.3f} ms, whole slices ({76 * C_eff * PACKS} B of "
                   f"shared memory a CTA) {t[1]:.3f} / {t[2]:.3f} ms; bitwise "
                   f"equal")
    q_ms = cuda_ms(query, 5)
    hit_frac = float(res.hit.float().mean())
    off_diag = int((~res.hit & ~diag).sum())
    if off_diag:
        raise AssertionError(f"phase {phase}: {off_diag} misses off the "
                             f"x == y line")
    if res.t.shape != (R0,) or not bool(torch.isfinite(res.t).all()):
        raise AssertionError(f"phase {phase}: t is not finite or has the "
                             f"wrong shape")
    hh, ht, hp = head
    if not torch.equal(hh, res.hit):
        raise AssertionError(f"phase {phase}: {int((hh != res.hit).sum())} "
                             f"hit-mask differences from the regrouped "
                             f"engine")
    trel = ((res.t - ht).abs() / ht.abs().clamp_min(1e-6))[hh]
    prim_diff = (res.prim_idx != hp) & hh
    if float(trel.max()) >= 2e-6:
        raise AssertionError(f"phase {phase}: t differs from the regrouped "
                             f"engine by rel {float(trel.max()):.3g}")
    same = (res.t.view(torch.int32) == ht.view(torch.int32)) \
        & (res.prim_idx == hp)
    say(phase, f"K1 bitwise equal to plain; {k5['desc']}; kernel {ms:.3f} "
               f"ms plain {plain_ms:.3f} ms bound {b[0]:.4f} ms ({b[1]})")
    say(phase, f"closest_hit_packed {R0} rays: {q_ms:.2f} ms median of 5 "
               f"({R0 / q_ms / 1e3:.3f} Mrays/s), launches {launches}; "
               f"hit_frac {hit_frac} ({int((~res.hit).sum())} misses, none "
               f"off the x == y line); against the regrouped engine: equal "
               f"hit masks, max rel t {float(trel.max()):.3g}, "
               f"{int(prim_diff.sum())} prims differ as ties, "
               f"{int(same.sum())} of {R0} rays bitwise identical in (hit, "
               f"t, prim)")
    return dict(blocks=k5["blocks"], err=k5["err"], ms=ms, plain_ms=plain_ms,
                bound=b, q_ms=q_ms)


def passes_phase(phase, ops_regroup, scene, rays, res, passes, reps):
    """The regrouped engine on ``rays`` at each of ``passes``, timed in
    turns (forward, then backward), each the median of ``reps`` after a
    warm-up; each against ``res`` (the query's result) ray for ray: equal
    hit masks, a differing prim only as a t tie, and the count of rays
    bitwise identical in (hit, t, prim). Returns {passes: [ms, ms]}."""
    query = {p: (lambda p=p: ops_regroup.closest_hit_regrouped(
        scene, rays, tile=2048, passes=p)) for p in passes}
    out = {p: q() for p, q in query.items()}                # warm-up
    times = {p: [] for p in passes}
    for order in (passes, passes[::-1]):
        for p in order:
            times[p].append(cuda_ms(query[p], reps))
    R = res.hit.numel()
    for p, r in out.items():
        n_hit, n_tie, _, _ = check_hits(res, r, f"phase {phase} passes={p}")
        same = (r.hit == res.hit) & (r.prim_idx == res.prim_idx) \
            & (r.t.view(torch.int32) == res.t.view(torch.int32))
        say(phase, f"passes={p}: {times[p][0]:.2f} / {times[p][1]:.2f} ms "
                   f"(median of {reps} after a warm-up, in turns "
                   f"{', '.join(map(str, passes + passes[::-1]))}); against "
                   f"the query's result: equal hit masks, {n_tie} prims "
                   f"differ as t ties, {int(same.sum())} of {R} rays "
                   f"bitwise identical in (hit, t, prim)")
    return times


def multiwave_phase(phase, rt, ops_dense, ops_regroup, dispatch, dev,
                    read_counts, zero_counts):
    """The blobby 1M cell: bench.py's RAYCORE_BENCH_SCENE=blobby at its
    defaults (blobby_mesh(707, 707), C=256, the 1024^2 Morton grid from
    z=3; MULTIWAVE_BLOBBY and MULTIWAVE_SIDE). The scene built cold and
    warm, its depth_layers and the passes that "auto" and dispatch
    resolve; closest_hit through dispatch (K1 once, K2 once, or twice
    where the route is the multiwave); K1 bitwise against its plain
    version on the query's phase-A inputs; the swept (subgroup, cluster) rows
    of passes 1, 2 and 4; K2 against its plain version and its
    kernel-order model on passes=4's wave grid and remainder grid; the
    regrouped engine at passes 1, 2 and 4 timed in turns and held to the
    query's result ray for ray; a 4096-ray oracle sample. Returns K2's
    numbers on the passes=4 path."""
    mesh = rt.blobby_mesh(n_theta=MULTIWAVE_BLOBBY, n_phi=MULTIWAVE_BLOBBY,
                          device=dev)

    def build():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = rt.build_dense(mesh, cluster_size=256)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t) * 1e3

    scene, cold_ms = build()
    scene, warm_ms = build()
    t = time.perf_counter()
    layers = rt.depth_layers(scene)
    layers_ms = (time.perf_counter() - t) * 1e3
    auto = ops_regroup.auto_passes(scene)
    routed = ops_regroup.resolve_passes(scene, dispatch.BIG_BATCH_PASSES)
    say(phase, f"blobby {mesh.vertices.shape[0]} tris, K "
               f"{scene.n_clusters}; build cold {cold_ms:.1f} ms warm "
               f"{warm_ms:.1f} ms; depth_layers {layers} ({layers_ms:.1f} "
               f"ms, once per scene), auto_passes {auto}, dispatch passes "
               f"{routed}")
    o, d = morton_grid_rays(MULTIWAVE_SIDE, dev)
    rays = rt.Ray.create(o, d)
    R = o.shape[0]

    zero_counts()
    res = rt.closest_hit(scene, rays)
    torch.cuda.synchronize()
    launches = read_counts("blobby 1M closest_hit",
                           ["phase_a", "refine_pairs", "regroup_sweep"])
    want_k2 = 2 if routed > 1 else 1
    if launches["phase_a"] != 1 or launches["refine_pairs"] != 1 \
            or launches["regroup_sweep"] != want_k2:
        raise AssertionError(f"blobby 1M closest_hit: launches {launches}, "
                             f"expected phase_a 1, refine_pairs 1 and "
                             f"regroup_sweep {want_k2}")
    if res.t.shape != (R,) or not bool(torch.isfinite(res.t).all()):
        raise AssertionError("blobby 1M: t is not finite or has the wrong "
                             "shape")
    hit_frac = float(res.hit.float().mean())
    if not 0.5 < hit_frac < 1.0:
        raise AssertionError(f"blobby 1M: hit_frac {hit_frac}")

    # The swept rows of each passes, from stage 1 on the query's rays.
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._swept_batch(
        rays, 2048, 32)[:7]
    SPB = 16
    rows = (po, pd, ptmin, ptmax)
    phase_a_check(f"K1 (phase {phase})", ops_dense, scene, rows, TILE)
    swept = {}
    for p in (1, 2, 4):
        out = ops_regroup._stage1_cm_core(scene, *rows, TILE, G, SPB,
                                          waves=p - 1)
        c = out[3]
        swept[p] = (c[1], c[2]) if p == 1 else (c[4] + c[2], c[5] + c[3])
        if p == 1:
            k2_one_ms = cuda_ms(lambda: ops_regroup.run_regrouped(
                out[1], out[0], out[2], scene.tri_feats, G=G, SPB=SPB,
                C=scene.cluster_size), 10)
    grid4 = out
    s1_ms = {p: cuda_ms(lambda p=p: ops_regroup._stage1_cm_core(
        scene, *rows, TILE, G, SPB, waves=p - 1), 3) for p in (1, 4)}
    say(phase, "swept (subgroup, cluster) rows and blocks: " + ", ".join(
        f"passes {p} {n} rows in {b} blocks ({swept[1][0] / n:.3f}x fewer "
        f"than passes 1)" for p, (n, b) in swept.items())
        + f"; at passes 4 the wave grid {grid4[3][4]} rows in "
        f"{grid4[3][5]} blocks and the remainder {grid4[3][2]} in "
        f"{grid4[3][3]}, of {grid4[3][1]} subgroup pairs (K1 bitwise equal "
        f"to plain on the query's phase-A inputs); stage 1 (with the "
        f"wave sweep at passes 4) {s1_ms[1]:.3f} ms at passes 1, "
        f"{s1_ms[4]:.3f} ms at passes 4; K2 on passes 1's grid "
        f"{k2_one_ms:.3f} ms")

    # K2 on passes=4's two grids.
    bc, bs, tbl, counts, wave = grid4
    kw = regroup_grid_check("K2 wave grid (passes 4)", ops_regroup, scene,
                            wave.block_cid, wave.block_subs, tbl, G, SPB,
                            phase, f"{counts[4]} wave pairs")
    kr = regroup_grid_check("K2 remainder grid (passes 4)", ops_regroup,
                            scene, bc, bs, tbl, G, SPB, phase + 1,
                            f"{counts[2]} remainder pairs")
    k2 = {}
    for name, g in (("wave", kw), ("remainder", kr)):
        k2[name] = (cuda_ms(g["run"], 10), cuda_ms(g["run_plain"], 3))
        say(phase, g["desc"] + f"; kernel {k2[name][0]:.3f} ms plain "
                   f"{k2[name][1]:.3f} ms bound {g['bound'][0]:.4f} ms "
                   f"({g['bound'][1]})")

    # The engine at passes 1, 2 and 4, in turns, against the query's
    # result.
    passes_phase(phase, ops_regroup, scene, rays, res, (1, 2, 4), 3)
    zero_counts()
    ops_regroup.closest_hit_regrouped(scene, rays, tile=2048, passes=4)
    torch.cuda.synchronize()
    launches4 = read_counts("blobby 1M passes=4",
                            ["phase_a", "refine_pairs", "regroup_sweep"])
    if launches4["regroup_sweep"] != 2:
        raise AssertionError(f"passes=4: launches {launches4}, expected 2 "
                             f"of regroup_sweep")
    rng = np.random.default_rng(SEED + phase)
    idx = torch.as_tensor(rng.choice(R, 4096, replace=False), device=dev)
    ref = rt.closest_hit_brute(scene.prims, rt.Ray.create(o[idx], d[idx]))
    n_hit, n_tie, _, _ = check_hits(ref, res.map(lambda a: a[idx]),
                                    "blobby 1M vs oracle")
    say(phase, f"sample vs brute oracle: {idx.numel()} rays, {n_hit} hits "
               f"agree, {n_tie} prim ties; launches through dispatch "
               f"{launches}, at passes 4 {launches4}")
    live = kw["live_rows"] + kr["live_rows"]
    b = bound(sum(nbytes(*g["args"][:3], *g["out"]) for g in (kw, kr))
              + table_bytes(torch.cat([wave.block_cid, bc]),
                            scene.cluster_size),
              live * scene.cluster_size * TEST_FLOPS)
    return dict(launches=launches4["regroup_sweep"],
                err=max(kw["err"], kr["err"]),
                ms=k2["wave"][0] + k2["remainder"][0],
                plain_ms=k2["wave"][1] + k2["remainder"][1], bound=b)


def instanced_inputs(rt, dev):
    """tools/tpu_instanced_bench.py's three base meshes and the
    INSTANCED_COUNT instance centres drawn from INSTANCED_SEED."""
    rng = np.random.default_rng(INSTANCED_SEED)
    bases = [rt.sphere_mesh(radius=0.45, n_theta=16, n_phi=32, device=dev),
             rt.box_mesh(device=dev),
             rt.sphere_mesh(radius=0.3, n_theta=10, n_phi=20, device=dev)]
    N = INSTANCED_COUNT
    centers = np.stack([rng.uniform(-8, 8, N), rng.uniform(-8, 8, N),
                        rng.uniform(-1, 1, N)], -1).astype(np.float32)
    return bases, centers


def instanced_frame_rays(side, device):
    """tools/tpu_instanced_bench.py's rays: a side x side grid over
    [-8.5, 8.5]^2 at z = 6 looking down, in row order."""
    xs = torch.linspace(-8.5, 8.5, side, dtype=torch.float32, device=device)
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    o = torch.stack([X, Y, torch.full_like(X, 6.0)], -1).reshape(-1, 3)
    d = torch.tensor([0.0, 0.0, -1.0], device=device).expand_as(o)
    return o, d.contiguous()


def edge_margin(v, o, d):
    """min(u, v, 1 - u - v) of rays (R, 3) against triangles (R, 3, 3),
    Möller–Trumbore in float64; NaN where the ray is parallel."""
    v, o, d = v.double(), o.double(), d.double()
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    s1 = torch.linalg.cross(d, e2)
    r = 1.0 / (s1 * e1).sum(1)
    dv = o - v[:, 0]
    u = (dv * s1).sum(1) * r
    w = (d * torch.linalg.cross(dv, e1)).sum(1) * r
    return torch.minimum(torch.minimum(u, w), 1.0 - u - w)


def instanced_check(what, ref, got, ref_rows, got_rows, soup, o, d):
    """The engine's result ``got`` against a reference in world space,
    ray for ray: equal hit masks, t within INSTANCED_T_TOL and the same
    winner, or else the same t within that tolerance (a tie). A ray that
    breaks this is a disagreement; each must be explained by an edge (the
    nearer winner's float64 barycentric margin within INSTANCED_EDGE of
    0), and there may be at most INSTANCED_EDGE_RATE of the rays (at
    least 4). ``ref_rows``/``got_rows`` are each winner's row of the world
    soup ``soup``. Returns (rows where both hit, differing winners that
    tie, disagreements)."""
    rh, gh = ref.hit, got.hit
    both = rh & gh
    rt_, gt = ref.t, got.t
    t_ok = (gt - rt_).abs() <= INSTANCED_T_TOL * (1 + rt_.abs())
    same = ref_rows == got_rows
    bad = (rh != gh) | (both & ~t_ok)
    n_bad = int(bad.sum())
    if n_bad:
        near_got = gh & (~rh | (gt < rt_))
        rows = torch.where(near_got, got_rows, ref_rows)[bad]
        m = edge_margin(soup.vertices[rows.clamp_min(0)], o[bad], d[bad])
        unexplained = int((~(m.abs() <= INSTANCED_EDGE)).sum())
        limit = max(4, int(INSTANCED_EDGE_RATE * rh.numel()))
        if unexplained or n_bad > limit:
            raise AssertionError(
                f"{what}: {n_bad} disagreements (at most {limit}), "
                f"{unexplained} not at an edge; margins "
                f"{m.cpu().numpy().tolist()[:8]}")
    return int(both.sum()), int((both & t_ok & ~same).sum()), n_bad


def instanced_phase(phase, rt, ops_dense, ops_regroup, dev, read_counts,
                    zero_counts):
    """The 256-instance dynamic frame (tools/tpu_instanced_bench.py at its
    defaults): build (the pushes, sync, bake_instanced) cold and warm; the
    query through dispatch with exactly one K1 and one K2 launch; the
    frames; K1 and K2 against their plain versions (and K2 against its
    kernel-order model) on the last frame's operands; an oracle and
    traversal sample; any_hit; the traversal's time. Returns K2's
    numbers on this path."""
    from raycore_tpu_torch.ops import instanced as ops_inst
    bases, centers = instanced_inputs(rt, dev)
    N = INSTANCED_COUNT

    def transform(i, shift):
        m = np.eye(3, 4, dtype=np.float32)
        m[:, 3] = centers[i] + shift
        return m

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr = rt.TLAS(device=dev)
        handles = [mgr.push(bases[i % len(bases)], transform(i, 0.0))
                   for i in range(N)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mgr.sync()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scene = rt.bake_instanced(mgr, cluster_size=128)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return mgr, handles, scene, [(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                     (t3 - t2) * 1e3]

    _, _, _, cold = build()
    mgr, handles, scene, warm = build()
    n_tris = sum(int(mgr._blas[r.blas_slot].n_prims) for r in mgr._instances)
    fmt = lambda ms: "/".join(f"{x:.1f}" for x in ms)
    say(phase, f"{N} instances ({n_tris} triangles in world space), "
               f"{mgr.n_geometries} BLAS, {scene.n_clusters} cluster rows "
               f"(at most {scene.max_clusters_per_blas} a BLAS), tri_feats "
               f"{scene.tri_feats.numel() * 4 / 1e6:.1f} MB; build (pushes/"
               f"sync/bake) cold {fmt(cold)} ms, warm {fmt(warm)} ms")

    o, d = instanced_frame_rays(INSTANCED_SIDE, dev)
    rays = rt.Ray.create(o, d)
    R = o.shape[0]
    zero_counts()
    res = rt.closest_hit(scene, rays)
    torch.cuda.synchronize()
    launches = read_counts("instanced closest_hit",
                           ["phase_a", "refine_pairs", "regroup_sweep",
                            "local_rays"])
    if (launches["phase_a"], launches["refine_pairs"],
            launches["regroup_sweep"], launches["local_rays"]) \
            != (1, 1, 1, 2):
        raise AssertionError(f"instanced closest_hit: launches {launches}, "
                             f"expected K1, K7 and K2 once each and K8's "
                             f"local rays twice")
    hit_frac = float(res.hit.float().mean())
    n_hit_inst = int(torch.unique(res.instance_idx).numel()) - 1
    if not 0.05 < hit_frac < 1.0 or n_hit_inst < N // 2:
        raise AssertionError(f"instanced closest_hit: hit_frac {hit_frac}, "
                             f"{n_hit_inst} instances hit")
    if res.t.shape != (R,) or not bool(torch.isfinite(res.t).all()):
        raise AssertionError("instanced t is not finite or has the wrong "
                             "shape")

    times = []
    for f in range(INSTANCED_FRAMES):
        for i, h in enumerate(handles):
            mgr.update_transform(h, transform(i, INSTANCED_STEP * (f + 1)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        scene = rt.refresh_instances(scene, mgr)
        res = rt.closest_hit(scene, rays)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(times)
    say(phase, f"closest_hit on {R} rays: hit_frac {hit_frac:.4f}, "
               f"{n_hit_inst} distinct instances hit, launches {launches}; "
               f"{INSTANCED_FRAMES} frames (refresh_instances + query): "
               f"{' '.join(f'{x:.2f}' for x in times)} ms, median {med:.2f} "
               f"ms ({R / med / 1e3:.3f} Mrays/s), spread "
               f"{min(times):.2f}-{max(times):.2f} ms, on {torch.cuda.get_device_name(0)}")

    # K1 and K2 on the last frame's operands.
    po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._padded_batch(
        rays, 2048, 32)
    SPB = 16
    phase_a_check("K1 instanced", ops_dense, SimpleNamespace(
        cluster_min=scene.inst_aabb_min, cluster_max=scene.inst_aabb_max),
        (po, pd, ptmin, ptmax), TILE)
    s1 = ops_inst._stage1_inst_core(scene, po, pd, ptmin, ptmax, TILE, G,
                                    SPB)
    C = scene.cluster_size
    kw = dict(G=G, SPB=SPB, C=C, payload="pairrow")
    pairs = (f"{s1.counts[0]} coarse (tile, instance), {s1.counts[1]} "
             f"(subgroup, instance) and {s1.counts[2]} (pair, cluster) pairs")
    k2 = grid_check(
        "K2 instanced regroup_sweep (pairrow)",
        lambda *a: ops_regroup.run_regrouped(*a, **kw),
        lambda *a: ops_regroup.run_regrouped_plain(*a, **kw),
        lambda *a, blocks: ops_regroup.run_regrouped_model(
            *a, **kw, blocks=blocks),
        scene, s1.block_cid, s1.block_subs, s1.tbl, G, SPB, C, phase, pairs)
    say(phase, f"K1 bitwise equal to plain; {k2['desc']}")
    k2_ms = cuda_ms(k2["run"], 10)
    k2_plain_ms = cuda_ms(k2["run_plain"], 3)
    # Where a frame's time goes: the refresh alone, stage 1 and stage 2
    # (each median of 5, CUDA events).
    refresh_ms = cuda_ms(lambda: rt.refresh_instances(scene, mgr), 5)
    st1_ms = cuda_ms(lambda: ops_inst._stage1_inst_core(
        scene, po, pd, ptmin, ptmax, TILE, G, SPB), 5)
    st2_ms = cuda_ms(lambda: ops_inst._stage2_inst_core(
        scene, s1, o, d, G, SPB, po.shape[0]), 5)
    say(phase, f"K2 pairrow kernel {k2_ms:.3f} ms plain {k2_plain_ms:.3f} "
               f"ms bound {k2['bound'][0]:.3f} ms ({k2['bound'][1]}); ray "
               f"table {s1.tbl.numel() * 4 / 1e6:.1f} MB; refresh_instances "
               f"{refresh_ms:.3f} ms, stage 1 {st1_ms:.3f} ms, stage 2 (K2, "
               f"combine, decode, finalize) {st2_ms:.3f} ms")
    del s1

    # any_hit on the frame's rays: its hit mask is the closest hit's.
    occ = rt.any_hit(scene, rays)
    if not torch.equal(occ.hit, res.hit):
        raise AssertionError(f"instanced any_hit: {int((occ.hit != res.hit).sum())}"
                             f" hit-mask differences from closest_hit")

    # A 4096-ray sample against the traversal and the oracle on the world
    # soup (the last frame's transforms).
    static = mgr.sync()
    sample = torch.as_tensor(np.random.default_rng(SEED + phase).choice(
        R, 4096, replace=False), device=dev)
    srays = rt.Ray.create(o[sample], d[sample])
    got = res.map(lambda a: a[sample])
    trav = rt.closest_hit(static, srays)
    # Each winner's row of the world soup, which holds every instance's
    # real BLAS prims in turn (each BLAS in its Morton order): the engine
    # names a row of its concatenated per-BLAS prims, the traversal a
    # BLAS-local prim, the oracle the soup row itself.
    soup, inst_of = rt.flatten_world_triangles(mgr)
    n_real = torch.tensor([mgr._blas[r.blas_slot].n_prims
                           for r in mgr._instances], device=dev)
    per_blas = torch.zeros(scene.n_instances, dtype=torch.long, device=dev)
    per_blas[scene.inst_blas.long()] = n_real
    prim_base = torch.cumsum(per_blas, 0) - per_blas
    soup_off = torch.cumsum(n_real, 0) - n_real

    def soup_rows(res, local):
        inst = res.instance_idx.long().clamp_min(0)
        p = res.prim_idx.long()
        if not local:
            p = p - prim_base[scene.inst_blas[inst].long()]
        return torch.where(res.hit, soup_off[inst] + p, -1)

    got_rows = soup_rows(got, False)
    n_both, n_tie, n_bad = instanced_check(
        "instanced vs traversal", trav, got, soup_rows(trav, True), got_rows,
        soup, o[sample], d[sample])
    oracle = rt.closest_hit_brute(soup, srays)
    o_both, o_tie, o_bad = instanced_check(
        "instanced vs oracle", oracle, got,
        torch.where(oracle.hit, oracle.prim_idx.long(), -1), got_rows, soup,
        o[sample], d[sample])
    say(phase, f"4096-ray sample: vs traversal {n_both} both hit, {n_tie} "
               f"differing winners at a t tie, {n_bad} disagreements at an "
               f"edge; vs brute oracle on {soup.vertices.shape[0]} world "
               f"triangles {o_both} both hit, {o_tie} ties, {o_bad} "
               f"disagreements at an edge; any_hit hit mask equal to "
               f"closest_hit's")

    # The traversal on a subset of the rays.
    sub = slice(None, None, INSTANCED_TRAVERSAL_STRIDE)
    trays = rt.Ray.create(o[sub].contiguous(), d[sub].contiguous())
    torch.cuda.synchronize()
    t = time.perf_counter()
    tres = rt.closest_hit(static, trays)
    torch.cuda.synchronize()
    trav_ms = (time.perf_counter() - t) * 1e3
    nt = trays.o.shape[0]
    sres = res.map(lambda a: a[sub])
    _, s_tie, s_bad = instanced_check(
        "instanced vs traversal (subset)", tres, sres, soup_rows(tres, True),
        soup_rows(sres, False), soup, trays.o, trays.d)
    say(phase, f"traversal (rt.closest_hit on mgr.sync()) on {nt} rays: "
               f"{trav_ms:.1f} ms ({nt / trav_ms / 1e3:.4f} Mrays/s); "
               f"against the engine {s_tie} ties, {s_bad} disagreements at "
               f"an edge")
    return dict(launches=launches["regroup_sweep"], err=k2["err"], ms=k2_ms,
                plain_ms=k2_plain_ms, bound=k2["bound"])


def pinhole_rays(side, device, dist=3.0, half=0.5):
    """A side x side pinhole camera at (0, 0, dist) looking down -z at
    pixel centres over [-half, half]^2 of the plane at distance 1: the
    unit sphere's silhouette (half-width 0.354 there) with misses around
    it. No ray has x or y = 0, so none runs along a meridian edge."""
    s = (np.arange(side, dtype=np.float32) + 0.5) / side * 2 * half - half
    X, Y = np.meshgrid(s, s, indexing="ij")
    d = np.stack([X, Y, -np.ones_like(X)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.array([0, 0, dist], np.float32), d.shape)
    return (torch.as_tensor(np.ascontiguousarray(o), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def brute_tests(ops_brute, table, o, d, ray_chunk=256):
    """K6's tests on this data, by how far each runs: (every (ray, table
    column) pair, the pairs that pass u, those that then pass v, the
    (warp, triangle) steps where the warp's vote sends it to the division
    because some ray of the warp may pass u, and all (warp, triangle)
    steps). Only tests that pass u (then v) need the rest of the test. u,
    v and the reject are the kernel's own bits (ops/brute.py:pair_tests).
    Every ray is live (t_min = 0, t_max = inf)."""
    T = table.shape[1]
    verts = table.T.reshape(T, 3, 3)
    W = ops_brute.WARP_RAYS
    n_u = torch.zeros((), dtype=torch.int64, device=o.device)
    n_v = torch.zeros_like(n_u)
    n_div = torch.zeros_like(n_u)
    for lo in range(0, o.shape[0], ray_chunk):
        oc, dc = o[lo:lo + ray_chunk], d[lo:lo + ray_chunk]
        inf = torch.full((oc.shape[0],), float("inf"), device=o.device)
        _, _, u, v, may = ops_brute.pair_tests(oc, dc, torch.zeros_like(inf),
                                               inf, verts)
        pass_u = (u >= 0.0) & (u <= 1.0)
        n_u += pass_u.sum()
        n_v += (pass_u & (v >= 0.0) & (u + v <= 1.0)).sum()
        n_div += may.reshape(-1, W, T).any(1).sum()
    steps = -(-o.shape[0] // W) * T
    return o.shape[0] * T, int(n_u), int(n_v), int(n_div), steps


def brute_phase(phase, rt, ops_brute, dev, read_counts, zero_counts):
    """closest_hit_brute_pallas on the unit sphere_mesh of BRUTE_SPHERE and
    BRUTE_SIDE^2 pinhole rays: K6 launched; its output on the main path's
    operands bit for bit equal to its plain version on a seeded subset of
    BRUTE_SUBSET rays (the plain version takes seconds on all rays); the
    whole batch equal to the oracle, bit for bit, on a 4096-ray sample.
    Returns a dict of K6's numbers."""
    n_theta, n_phi = BRUTE_SPHERE
    tris = rt.sphere_mesh(n_theta=n_theta, n_phi=n_phi, device=dev)
    T = tris.vertices.shape[0]
    o, d = pinhole_rays(BRUTE_SIDE, dev)
    R = o.shape[0]
    rays = rt.Ray.create(o, d)
    zero_counts()
    res = rt.closest_hit_brute_pallas(tris, rays)
    torch.cuda.synchronize()
    launches = read_counts("closest_hit_brute_pallas", ["brute_sweep"])
    hit_frac = float(res.hit.float().mean())
    if not 0.2 < hit_frac < 0.8:
        raise AssertionError(f"dense sweep hit_frac {hit_frac}: the view "
                             f"should hold hits and misses")
    # The kernel's operands as closest_hit_brute_pallas builds them (R is
    # a whole number of ray tiles, so nothing is padded).
    table = ops_brute.make_tri_table(tris)
    args = (table, o, d, torch.zeros(R, device=dev),
            torch.full((R,), float("inf"), device=dev))
    got = ops_brute.run_brute(*args)
    rng = np.random.default_rng(SEED + phase)
    sub = torch.as_tensor(
        np.sort(rng.choice(R, BRUTE_SUBSET, replace=False)), device=dev)
    sub_args = [a if a is table else a[sub] for a in args]
    out = {}
    plain_ms = cuda_ms(lambda: out.update(
        ref=ops_brute.run_brute_plain(*sub_args)), 1)
    ref = out["ref"]
    for name, g, r in zip(("t", "idx", "u", "v"), got, ref):
        if not torch.equal(g[sub].view(torch.int32), r.view(torch.int32)):
            raise AssertionError(
                f"K6 {name}: {int((g[sub].view(torch.int32) != r.view(torch.int32)).sum())}"
                f" of {sub.numel()} subset rows differ from the plain "
                f"version")
    err = max(float((g[sub] - r).abs().max()) for g, r in zip(got, ref))
    ms = cuda_ms(lambda: ops_brute.run_brute(*args), 3)
    q_ms = cuda_ms(lambda: rt.closest_hit_brute_pallas(tris, rays), 3)
    # The oracle on a 4096-ray sample: every field bit for bit.
    idx = torch.as_tensor(rng.choice(R, 4096, replace=False), device=dev)
    oracle = rt.closest_hit_brute(tris, rt.Ray.create(o[idx], d[idx]))
    for f in ("hit", "t", "barycentric", "prim_idx", "instance_idx"):
        a, b = getattr(oracle, f), getattr(res, f)[idx]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"dense sweep {f}: {int((a != b).sum())} "
                                 f"of 4096 sampled rays differ from the "
                                 f"oracle")
    # The operations this data needs: every test up to u, the rest only
    # where u (then v) passes; the table and the rays are read once and
    # the four outputs written once.
    pairs, n_u, n_v, n_div, steps = brute_tests(ops_brute, table, o, d)
    full = BRUTE_U_FLOPS + BRUTE_V_FLOPS + BRUTE_T_FLOPS
    b = bound(nbytes(*args, *got), pairs * BRUTE_U_FLOPS
              + n_u * BRUTE_V_FLOPS + n_v * BRUTE_T_FLOPS)
    say(phase, f"closest_hit_brute_pallas {T} tris (table "
               f"{tuple(table.shape)}) x {R} pinhole rays: {q_ms:.3f} ms "
               f"median of 3 ({R / q_ms / 1e3:.3f} Mrays/s), launches "
               f"{launches}; hit_frac {hit_frac:.4f}; K6 brute_sweep bitwise "
               f"equal to plain on {sub.numel()} subset rows, kernel "
               f"{ms:.3f} ms, plain {plain_ms:.3f} ms on the subset, bound "
               f"{b[0]:.4f} ms ({b[1]}; {pairs} tests, {n_u} pass u, {n_v} "
               f"pass v; {pairs * full / PEAK_FP32_FLOPS * 1e3:.4f} ms if "
               f"every test ran in full); {n_div} of {steps} (warp, "
               f"triangle) steps ({n_div / steps:.4%}) took the division "
               f"path; 4096-ray sample bitwise equal to the oracle")
    return dict(launches=launches["brute_sweep"], err=err, ms=ms,
                plain_ms=plain_ms, bound=b, q_ms=q_ms,
                div_share=n_div / steps)


def shadow_oracle(rt, scene, rays, occ, t_occ, rng):
    """any_hit's mask against the oracle's closest hit with t_min = 0 on a
    4096-ray sample. Rays may disagree only where the oracle's hit or the
    port's occluder lies within NEAR_SURFACE_T of the origin, at most
    NEAR_SURFACE_FLIPS_MAX of them. Returns (differences, near rays)."""
    R = rays.o.shape[0]
    idx = torch.as_tensor(rng.choice(R, 4096, replace=False),
                          device=rays.o.device)
    ref = rt.closest_hit_brute(scene.prims, rt.Ray.create(
        rays.o[idx], rays.d[idx], t_max=rays.t_max[idx]))
    got = occ.hit[idx]
    near = (ref.hit & (ref.t < NEAR_SURFACE_T)) \
        | (got & (t_occ[idx] < NEAR_SURFACE_T))
    flip = ref.hit != got
    n_flip, n_far = int(flip.sum()), int((flip & ~near).sum())
    if n_far or n_flip > NEAR_SURFACE_FLIPS_MAX:
        raise AssertionError(
            f"shadow rays vs oracle: {n_far} hit differences away from the "
            f"surface (none allowed), {n_flip} in all (at most "
            f"{NEAR_SURFACE_FLIPS_MAX}, all within t < {NEAR_SURFACE_T})")
    return n_flip, int(near.sum())


def probe_result(name, replaces, launches, err, ms, plain_ms, b, library_ms,
                 path=None, products_bound=None):
    """A probe's entry of the kernels line; ``products_bound`` (ms), where
    given, the time of every product the kernel computes at its unit's
    peak, beside the function's own bound ``b``."""
    return dict(name=name, replaces=replaces, launches=launches, err=err,
                ms=ms, plain_ms=plain_ms, bound=b, library_ms=library_ms,
                path=path, products_bound=products_bound)


def gather_in_tier(p1, idx, tbl, variant, tier):
    """P1's ``variant`` in ``tier`` (4 or 0), whatever ``gather_tier``
    picks: the launcher's entry called directly, to time the tiers side
    by side. Not counted as a launch."""
    from raycore_tpu_torch.tools._common import launch

    out = torch.empty((idx.shape[0] // p1.R, p1.W), device=idx.device)
    launch("gather_probe", idx.device, idx.data_ptr(), tbl.data_ptr(),
           out.data_ptr(), tbl.shape[0], out.shape[0],
           p1.VARIANTS.index(variant), tier)
    return out


def bank_aligned(idx, variant, R):
    """``idx`` with each index moved within its aligned group of 8 rows so
    that the 8 lanes of a quarter warp of ``variant``'s shared-memory
    kernel read 8 distinct 16-byte bank groups (row % 8 == lane % 8): in
    ``loop`` lane l holds step 32 n + l, in ``take`` lane l reads
    positions 128 k + 4 l + j of its step. The rows stay uniform over a
    table of a multiple of 8 rows, and the index stream is unchanged."""
    pos = torch.arange(idx.numel(), device=idx.device)
    lane = pos // R if variant == "loop" else pos % R // 4
    return idx - idx % 8 + (lane % 8).to(idx.dtype)


def gather_phase(phase, p1, dev, read_counts, zero_counts):
    """P1 at the tool's default shapes, an (8192, 128) table and 2,048
    steps of 512 fetches: every variant against its plain version within
    ``gather_probe.tolerance``; ``loop`` and ``take`` bit for bit against
    ``run_gather_model`` in their tier (``gather_tier``); the tool's rows
    through its main() on the same data, the launches counted there and
    its times (best of 5 samples of ``CALLS`` calls) those of the kernels
    line. Three entries there:
    ``loop``, ``onehot`` and ``take``, each beside its own plain version
    and ``index_select`` and a sum (the tool's ``xla`` row). Bound of all
    three, the function's: the indices, the table and the output moved
    once, one addition per fetched element. ``onehot`` also states the
    bound of the products it computes, 2 * 512 * NN * 128 a step at the
    bf16 peak (``products_bound_ms``). Printed beside ``loop`` and
    ``take``: the rate of the rows fetched (steps * 512 * 512 bytes) and
    the on-chip ceiling, those bytes through every SM's load path at 128
    bytes a clock at the card's maximum SM clock; their times on
    ``bank_aligned`` indices, the same index stream with gathers free of
    bank conflicts; and both tiers at each of ``GATHER_SWEEP``'s table
    rows, each bit for bit its model, beside the tier ``gather_tier``
    picks."""
    from raycore_tpu_torch.tools._common import best_ms, check_equal

    NN, steps = GATHER_SHAPE
    idx, tbl = p1.make_inputs(NN, steps, dev)
    tier = p1.gather_tier(NN)
    errs = {}
    for v in p1.VARIANTS:
        got = p1.run_gather(idx, tbl, v)
        err = (got - p1.run_gather_plain(idx, tbl, v)).abs()
        ratio = float((err / p1.tolerance(idx, tbl, v)).max())
        if ratio > 1:
            raise AssertionError(f"P1 {v}: error {ratio:.3g} x the bound")
        errs[v] = float(err.max())
        if v != "onehot":
            check_equal(got, p1.run_gather_model(idx, tbl, v, tier),
                        f"P1 {v} against its model, tier {tier}")
    say(phase, "gather probe: " + ", ".join(
        f"{v} max err {e:.3g}" for v, e in errs.items())
        + " (within 2^-14 of the fetched magnitudes); loop and take bit "
          f"for bit their model in tier {tier} (columns a shared-memory "
          "slice; 0: the L2 tier); the tool's rows:")
    zero_counts()
    rows = {r["variant"]: r["ms"] for r in p1.main(NN, steps, reps=5,
                                                   device=dev)}
    torch.cuda.synchronize()
    launches = read_counts("gather probe main", ["gather_probe"])
    by_variant = dict(p1.run_gather.by_variant)
    ms = {v: rows[v] for v in p1.VARIANTS}
    library_ms = rows["library"]
    plain_ms = {v: cuda_ms(lambda v=v: p1.run_gather_plain(idx, tbl, v), 3)
                for v in p1.VARIANTS}
    moved = nbytes(idx, tbl) + steps * p1.W * 4
    b = bound(moved, idx.numel() * p1.W)
    products = 2 * p1.R * NN * p1.W * steps / PEAK_BF16_FLOPS * 1e3
    fetched = idx.numel() * p1.W * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    ceiling = fetched / (sms * 128 * mhz * 1e6) * 1e3
    # Every slice reads every index: the index stream of the slices.
    streamed = (p1.W // 4) * nbytes(idx) if tier else nbytes(idx)
    aligned_ms = {}
    for v in ("loop", "take"):
        ids = bank_aligned(idx, v, p1.R)
        check_equal(p1.run_gather(ids, tbl, v),
                    p1.run_gather_model(ids, tbl, v, tier),
                    f"P1 {v} against its model, bank-aligned indices")
        aligned_ms[v] = best_ms(lambda v=v, ids=ids: p1.run_gather(ids, tbl, v),
                                5, p1.CALLS)
    say(phase, f"gather probe (NN {NN}, {steps} steps): " + ", ".join(
        f"{v} {t:.4f} ms" for v, t in ms.items())
        + "; plain " + ", ".join(f"{v} {t:.4f} ms"
                                 for v, t in plain_ms.items())
        + f"; library {library_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); "
          f"onehot {ms['onehot'] / b[0]:.0f}x that bound and "
          f"{ms['onehot'] / library_ms:.2f}x the library; the products "
          f"onehot computes at the bf16 peak {products:.4f} ms, "
          f"{products / ms['onehot']:.1%} of its time; launches "
          f"{launches}, by variant {by_variant}")
    say(phase, f"gather probe loop and take, tier {tier}: {fetched} bytes "
               f"of rows fetched; on-chip ceiling {ceiling:.4f} ms ({sms} "
               f"SMs x 128 B a clock at {mhz} MHz); " + ", ".join(
                   f"{v} {fetched / ms[v] / 1e9:.2f} TB/s, "
                   f"{ceiling / ms[v]:.1%} of the ceiling and "
                   f"{b[0] / ms[v]:.1%} of the bound" for v in ("loop",
                                                                "take"))
               + f"; index stream {streamed} bytes, "
               + ", ".join(f"{v} {streamed / ms[v] / 1e9:.2f} TB/s"
                           for v in ("loop", "take"))
               + "; on bank-aligned indices (the same stream, no bank "
                 "conflicts; bit for bit the model): "
               + ", ".join(f"{v} {t:.4f} ms, index stream "
                           f"{streamed / t / 1e9:.2f} TB/s"
                           for v, t in aligned_ms.items()))
    for n in GATHER_SWEEP:
        ids, t = p1.make_inputs(n, steps, dev, seed=n)
        tiers = {}
        for v in ("loop", "take"):
            for k in (4, 0):
                check_equal(gather_in_tier(p1, ids, t, v, k),
                            p1.run_gather_model(ids, t, v, k),
                            f"P1 {v} in tier {k}, NN {n}, against its model")
                tiers[v, k] = best_ms(
                    lambda v=v, k=k: gather_in_tier(p1, ids, t, v, k), 5,
                    p1.CALLS)
        say(phase, f"gather probe tiers, NN {n}, {steps} steps: " + ", ".join(
            f"{v} slices {tiers[v, 4]:.4f} ms, L2 {tiers[v, 0]:.4f} ms"
            for v in ("loop", "take")) + f"; gather_tier {p1.gather_tier(n)}")
    return [probe_result("gather_probe", f"tools/tpu_gather_probe.py:{line}",
                         by_variant[v], errs[v], ms[v], plain_ms[v], b,
                         library_ms, path=v,
                         products_bound=products if v == "onehot" else None)
            for v, line in (("loop", 39), ("onehot", 46), ("take", 56))]


def epilogue_phase(phase, p2, dev, read_counts, zero_counts):
    """P2 at the tool's default shapes (64 tiles of 512 rows, 8,192
    blocks): every variant against its plain version at those 8,192
    blocks (the plain version computes each visited tile once, as blocks
    on a tile write the same keys) under the tool's key0 seed (t a NaN:
    nothing accepted) and under a seed that decodes to t = 10; the
    accepted share of ``full`` under both seeds; every variant timed under
    both seeds; the tool's rows through its main() (the tool's seed), the
    launches counted there and its ``full`` row the kernels line's time.
    Bound of ``full``: 128 FLOP per (row, lane) over every block, every
    tile's rows, tmin, key0 and table read once, the keys written once.
    The VPU rows' bound counts issue slots: their 19 products and 15
    additions are each rounded, so no FFMA fuses them, and each takes a
    slot of the float32 pipe (PEAK_FP32_ADDS a second); the old 38 FLOP
    a pair at the FMA peak counted fused pairs that cannot be fused."""
    TILE, n_blocks = EPILOGUE_SHAPE
    phi, feats, tmin, key0 = p2.make_inputs(TILE, device=dev)
    seeds = {"tool": key0, "finite": p2.finite_key0(key0.shape[0],
                                                    device=dev)}
    worst, beyond = 0.0, 0
    t0 = time.perf_counter()
    for v in p2.VARIANTS:
        for name, k0 in seeds.items():
            kw = dict(TILE=TILE, n_blocks=n_blocks, variant=v)
            n, err = p2.check(p2.run_epilogue(phi, feats, tmin, k0, **kw),
                              p2.run_epilogue_plain(phi, feats, tmin, k0,
                                                    **kw),
                              v, f"P2 ({name} seed)")
            worst, beyond = max(worst, err), beyond + n
    check_s = time.perf_counter() - t0
    full = lambda k0: p2.run_epilogue(phi, feats, tmin, k0, TILE=TILE,
                                      n_blocks=n_blocks, variant="full")
    share = {name: float((full(k0) != k0).float().mean())
             for name, k0 in seeds.items()}
    plain_ms = cuda_ms(lambda: p2.run_epilogue_plain(
        phi, feats, tmin, key0, TILE=TILE, n_blocks=n_blocks,
        variant="full"), 1)
    every = {name: {v: cuda_ms(lambda v=v, k0=k0: p2.run_epilogue(
        phi, feats, tmin, k0, TILE=TILE, n_blocks=n_blocks, variant=v), 3)
        for v in p2.VARIANTS} for name, k0 in seeds.items()}
    say(phase, f"epilogue probe: 7 variants x 2 seeds at {n_blocks} "
               f"blocks equal to plain ({beyond} rows past the approximate "
               f"reciprocal's bound, max t err {worst:.3g}; {check_s:.1f} s)"
               f"; full accepts {share['tool']:.4f} of rows under the "
               f"tool's seed 0x7FFFFF80 and {share['finite']:.4f} under "
               f"t = 10; every variant at TILE {TILE}, " + "; ".join(
                   f"{name} seed: " + ", ".join(
                       f"{v} {t:.4f} ms" for v, t in times.items())
                   for name, times in every.items())
        + f"; full - matmul_only under t = 10: "
          f"{every['finite']['full'] - every['finite']['matmul_only']:.4f}"
          f" ms; the tool's rows:")
    zero_counts()
    rows = p2.main(TILE, n_blocks, reps=3, device=dev)
    torch.cuda.synchronize()
    launches = read_counts("epilogue probe main", ["epilogue_probe"])
    ms = next(r["ms"] for r in rows
              if r["variant"] == "full" and r["TILE"] == TILE)
    C = p2.C

    def row_bound(r):
        pairs = r["n_blocks"] * r["TILE"] * C
        if "vpu" in r["variant"]:
            return (f"{pairs * 34 / PEAK_FP32_ADDS * 1e3:.4f} ms (34 issue "
                    f"slots; 38 FLOP at the FMA peak, the old count, "
                    f"{pairs * 38 / PEAK_FP32_FLOPS * 1e3:.4f})")
        return f"{pairs * 128 / PEAK_FP32_FLOPS * 1e3:.4f} ms"

    say(phase, "bounds (operations): " + ", ".join(
        f"{r['label']} {r['ms']:.4f} ms against {row_bound(r)}"
        for r in rows) + f"; launches {launches}")
    b = bound(nbytes(phi, feats, tmin, key0) + key0.numel() * 4,
              n_blocks * TILE * C * 128)
    return probe_result("epilogue_probe", "tools/epilogue_experiments.py:28",
                        launches["epilogue_probe"], worst, ms, plain_ms, b,
                        None)


def check_tier(p3, a, b, got, want, v, what):
    """Hold P3's row sums ``got`` at tier ``v`` to its plain version
    ``want``: the FMA tier bit for bit, the tensor-core tiers within
    ``probe_matmul_shapes.tolerance``. Returns (max abs error, the error
    in units of the limit; 0 for fma)."""
    err = (got - want).abs()
    if v == "fma":
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"P3 {what}: not bit for bit equal to "
                                 f"plain")
        return float(err.max()), 0.0
    ratio = float((err / p3.tolerance(a, b, v)).max())
    if ratio > 1:
        raise AssertionError(f"P3 {what}: error {ratio:.3g} x its limit")
    return float(err.max()), ratio


def matmul_phase(phase, p3, dev, read_counts, zero_counts):
    """P3: the four tiers at (512, K, 512), K = 16 and 128, against the
    plain version of each tier (``check_tier``), whose limit must sit below
    the gap to the neighbouring tier's product (``tier_gap``); each tier's
    distance from the exact product is printed beside it. Then the tool's
    twelve rows through its main() and the 3xTF32 tier at (512, 16, 512),
    which the tool does not run, the launches counted there; every row's
    32,768-step time at least STEP_RATIO_MIN times its 8,192-step time
    (each step computes its own product), its time a step beside
    ``step_bound_us``, and its output at 8,192 steps, where every CTA walks
    many steps, held to its plain version (``check_tier``). The kernels
    line takes the FMA tier's (512, 16, 512) row of main() at its first
    step count, beside its plain version and torch.matmul on the operands
    expanded to as many steps."""
    f32, bf16 = torch.float32, torch.bfloat16
    tiers = (("highest", f32), ("high", f32), ("default", f32),
             ("default", bf16))
    errs, worst = [], 0.0
    for K in (16, 128):
        for prec, dtype in tiers:
            a, b = p3.operands(512, K, 512, dtype, dev)
            v = p3.variant_of(prec, dtype)
            got = p3.run_matmul(a, b, 4, prec)
            want = p3.run_matmul_plain(a, b, 4, prec)
            S = (a.double().abs() @ b.double().abs()).sum(1, keepdim=True)
            exact = (a.double() @ b.double()).sum(1, keepdim=True)
            err, ratio = check_tier(p3, a, b, got, want, v, f"{v} K={K}")
            worst = max(worst, err)
            note = f"{v} K={K}: "
            if v == "fma":
                note += "bit for bit"
            else:
                rel = float(((got - want).abs() / S).max())
                note += (f"err {err:.3g} = 2^"
                         f"{math.log2(max(rel, 2.0 ** -60)):.2f} S, "
                         f"{ratio:.3g} of its limit")
                if v != "bf16":
                    gap = p3.tier_gap(a, b, v)
                    if gap <= 1:
                        raise AssertionError(f"P3 {v} K={K}: the limit does "
                                             f"not tell it from its "
                                             f"neighbour ({gap:.3g})")
                    note += f", neighbour {gap:.3g} limits away"
            off = float(((got.double() - exact).abs() / S).max())
            errs.append(note + f"; from the exact product 2^"
                        f"{math.log2(max(off, 2.0 ** -60)):.2f} S")
    say(phase, "matmul probe vs plain (S: the row's sum of product "
               "magnitudes): " + "; ".join(errs) + "; the tool's rows:")
    zero_counts()
    rows = p3.main(reps=3, device=dev)
    say(phase, "3xTF32, which the tool does not run:")
    rows.append(p3.probe(512, 16, 512, "high", f32, reps=3, device=dev))
    torch.cuda.synchronize()
    launches = read_counts("matmul probe main", ["matmul_probe"])
    shares = []
    for r in rows:
        ratio = r["ms"][1] / r["ms"][0]
        need = step_bound_us(r["M"], r["K"], r["N"], r["variant"])
        what = f"({r['M']}, {r['K']}, {r['N']}) {r['variant']}"
        a, b = p3.operands(r["M"], r["K"], r["N"], getattr(torch, r["dtype"]),
                           dev)
        n = r["steps"][0]
        err, limits = check_tier(p3, a, b, p3.run_matmul(a, b, n, r["prec"]),
                                 p3.run_matmul_plain(a, b, n, r["prec"]),
                                 r["variant"], f"{what} at {n} steps")
        worst = max(worst, err)
        shares.append(f"{what}: at {n} steps "
                      + ("bit for bit" if r["variant"] == "fma" else
                         f"{limits:.3g} of its limit")
                      + f"; {r['steps'][1]} / {n} steps {ratio:.3f}x, "
                      f"{r['us_per_step']:.4f} us a step vs "
                      f"{need[0]:.4f} ({need[1]}, "
                      f"{need[0] / r['us_per_step']:.1%})")
        if ratio < STEP_RATIO_MIN:
            raise AssertionError(
                f"P3 {what}: {r['steps'][1]} steps took {ratio:.3f}x the "
                f"time of {n} (at least {STEP_RATIO_MIN}): a step did not "
                f"compute its own product")
    say(phase, "each row against its plain version, its step ratio and its "
               "time a step against its bound (fma: its products on the "
               "float32 pipe; the tensor-core tiers: the larger of their "
               "products at the tier's peak and the M (N - 1) row-sum "
               f"additions at {PEAK_FP32_ADDS / 1e12:.1f} T a second): "
        + "; ".join(shares) + f"; launches {launches}")
    at = {r["variant"]: r for r in rows
          if (r["M"], r["K"], r["N"]) == (512, 16, 512)}
    steps, ms = at["fma"]["steps"][0], at["fma"]["ms"][0]
    a, b = p3.operands(512, 16, 512, f32, dev)
    plain_ms = cuda_ms(lambda: p3.run_matmul_plain(a, b, steps, "highest"),
                       3)
    library_ms = cuda_ms(lambda: p3.matmul_library(a, b, steps, "highest"),
                         3)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the matmul probe left allow_tf32 set")
    bnd = bound(nbytes(a, b) + 512 * 4, steps * 2 * 512 * 16 * 512)
    say(phase, f"fma tier (512, 16, 512) x {steps} steps: kernel {ms:.4f} "
               f"ms, plain {plain_ms:.4f} ms (one product), library "
               f"{library_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, its "
               f"products)")
    return probe_result("matmul_probe", "tools/probe_matmul_shapes.py:30",
                        launches["matmul_probe"], worst, ms, plain_ms, bnd,
                        library_ms)


def step_bound_us(M, K, N, variant):
    """(µs, what bounds it): the least time a step of P3 takes at
    ``variant``. The FMA tier: its M K N fused multiply-adds (2 M K N
    operations) on the float32 pipe, one chain over k and n giving a row's
    sum with no further addition; the tensor-core tiers: the larger of 2 M
    K N operations a pass at the tier's peak (3xTF32 makes three passes)
    and the M (N - 1) row-sum additions of the (M, N) product at
    PEAK_FP32_ADDS."""
    if variant == "fma":
        return 2 * M * K * N / PEAK_FP32_FLOPS * 1e6, "operations"
    peak, passes = {"3xtf32": (PEAK_TF32_FLOPS, 3),
                    "tf32": (PEAK_TF32_FLOPS, 1),
                    "bf16": (PEAK_BF16_FLOPS, 1)}[variant]
    mma = 2 * M * K * N * passes / peak * 1e6
    adds = M * (N - 1) / PEAK_FP32_ADDS * 1e6
    return (mma, "tensor cores") if mma >= adds else (adds, "row sums")


def block_phase(phase, p4, dev, read_counts, zero_counts, k2_us):
    """P4 at the tool's default shapes (a 32,768-subgroup ray table, 8,192
    clusters): every row of the tool against its plain version at the
    tool's 8,192 blocks, where each persistent CTA walks many blocks and
    its cursors wrap, bit for bit; full and no_matmul at SPB 16 also
    through the model routed through the kernel's division-free pre-test
    (``run_block_model``), equal to plain, with the share of (row, lane)
    pairs it refuses; the tool's rows through its main(), the launches
    counted there, its ``full`` row at SPB 16 the kernels line's time,
    held beside K2's time per headline block (``k2_us``, phase 5). Bound:
    104 FLOP per (row, lane), each distinct gathered subgroup and each
    distinct cluster's 13 used feature rows read once (main() counts
    them), the ids read and both outputs written once."""
    from raycore_tpu_torch.tools._common import check_equal
    tbl, feats, gen = p4.make_inputs(device=dev)
    n_sub, K = tbl.shape[0] - 1, feats.shape[0]
    refused, t0 = {}, time.perf_counter()
    for v, G, SPB in p4.CONFIGS:
        ids = p4.block_ids(PROBE_BLOCKS, SPB, n_sub, K, gen)
        tblc = torch.randn((PROBE_BLOCKS, G * SPB, 16), generator=gen,
                           device=dev) if v == "contig_tbl" else None
        args = (v, G, SPB, *ids, tbl, feats, tblc)
        want = p4.run_block_plain(*args)
        check_equal(p4.run_block(*args), want, f"P4 {v} SPB={SPB}")
        if (v, SPB) in (("full", 16), ("no_matmul", 16)):
            got, n = p4.run_block_model(*args)
            check_equal(got, want, f"P4 model {v} SPB={SPB}")
            refused[v] = n / (PROBE_BLOCKS * G * SPB * p4.C)
        if (v, SPB) == ("full", 16):
            ids16 = ids
        del want, tblc
    check_s = time.perf_counter() - t0
    n_plain = 64
    plain_ms = cuda_ms(lambda: p4.run_block_plain(
        "full", 32, 16, ids16[0][:n_plain * 16], ids16[1][:n_plain], tbl,
        feats), 1)
    say(phase, f"block probe: every row of the tool bit for bit equal to "
               f"plain at {PROBE_BLOCKS} blocks ({check_s:.1f} s); the "
               f"pre-test refuses {refused['full']:.4f} of full's (row, "
               f"lane) pairs and {refused['no_matmul']:.4f} of "
               f"no_matmul's; the tool's rows:")
    zero_counts()
    row = next(r for r in p4.main(PROBE_BLOCKS, reps=3, device=dev)
               if (r["variant"], r["SPB"]) == ("full", 16))
    torch.cuda.synchronize()
    launches = read_counts("block probe main", ["block_probe"])
    n_blocks, G, SPB, ms = row["n_blocks"], row["G"], row["SPB"], row["ms"]
    rows = n_blocks * G * SPB
    b = bound(row["distinct_subs"] * G * 16 * 4
              + row["distinct_cids"] * 13 * 4 * p4.C * 4
              + (n_blocks * SPB + n_blocks) * 4 + 2 * rows * 4,
              rows * p4.C * 104)
    us = ms * 1e3 / n_blocks
    say(phase, f"full SPB {SPB}: {ms:.3f} ms for {n_blocks} blocks, "
               f"{us:.4f} us/block ({us * 1e6 / (G * SPB * p4.C):.3f} ps "
               f"per (row, lane)); K2 on the headline's blocks {k2_us:.4f} "
               f"us/block ({k2_us * 1e6 / (32 * 16 * 256):.3f} ps per (row, "
               f"lane), 256 lanes, 19 terms); plain {plain_ms:.3f} ms on "
               f"{n_plain} blocks; bound {b[0]:.4f} ms ({b[1]}); launches "
               f"{launches}")
    return probe_result("block_probe", "tools/probe_block_overhead.py:70",
                        launches["block_probe"], 0.0, ms, plain_ms, b, None)


def timed_call(fn):
    """(fn(), ms): one call between CUDA events, host syncs included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@contextlib.contextmanager
def kept_queries(dispatch):
    """Inside the block every query through ``dispatch``'s
    scene_closest_hit and scene_any_hit runs between two host syncs and
    is kept, in order: a list of dicts (kind "closest" or "shadow", the
    rays, the result, perf_counter before and after, the live rays)."""
    kept = []
    saved = dispatch.scene_closest_hit, dispatch.scene_any_hit

    def keep(fn, kind):
        def wrapped(scene, rays, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(scene, rays, *a, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kept.append(dict(kind=kind, rays=rays, out=out, t0=t0, t1=t1,
                             live=int((rays.t_max >= 0).sum())))
            return out
        return wrapped

    dispatch.scene_closest_hit = keep(saved[0], "closest")
    dispatch.scene_any_hit = keep(saved[1], "shadow")
    try:
        yield kept
    finally:
        dispatch.scene_closest_hit, dispatch.scene_any_hit = saved


def frame_kernels(phase, rt, ops_dense, ops_regroup, scene, queries):
    """K1 and K2 on the operands of each regrouped query of a frame, as
    the engine builds them (any_hit's rays with t_min forced to 0, padded
    to tiles of 2048 in subgroups of 32, in the order the engine sweeps
    them, ``ops/regroup.py:_swept_batch``): K1 bitwise against its plain
    version and its model; K2 against its plain version and bit for bit
    against its kernel-order model on sampled blocks. Returns, for each
    kernel, the largest error and the sums over the queries of its time
    (median of 3), its plain version's (one run for K2) and the bytes and
    operations of its bound."""
    sums = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0)
            for k in ("k1", "k2")}
    parts = []

    def add(k, err, ms, plain_ms, n_bytes, flops):
        a = sums[k]
        a["err"] = max(a["err"], err)
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["bytes"] += n_bytes
        a["flops"] += flops

    for i, q in enumerate(queries):
        rays = q["rays"]
        if q["kind"] == "shadow":
            rays = rt.Ray.create(rays.o, rays.d, t_max=rays.t_max)
        po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._swept_batch(
            rays, 2048, 32)[:7]
        rows = (po, pd, ptmin, ptmax)
        what = f"bounce {i // 2} {q['kind']}"
        stats, bounds, ek, err, slow = phase_a_check(
            f"K1 {what}", ops_dense, scene, rows, TILE)
        k1_ms = graph_ms(lambda: ops_dense.phase_a(stats, bounds), 3)
        add("k1", err, k1_ms, cuda_ms(lambda: ops_dense.phase_a_plain(
            stats, bounds), 3), nbytes(stats, bounds, ek),
            ek.numel() * K1_PAIR_FLOPS)
        del stats, bounds, ek
        g = regroup_sweep_check(f"K2 {what}", ops_regroup, scene, rows,
                                TILE, G, 16, phase)
        k2_ms = cuda_ms(g["run"], 3)
        add("k2", g["err"], k2_ms, cuda_ms(g["run_plain"], 1), g["bytes"],
            g["flops"])
        say(phase, g["desc"])
        parts.append(f"{what} K1 {k1_ms:.4f} ms ({slow} pairs on the plain "
                     f"arithmetic), K2 {k2_ms:.3f} ms on {g['blocks']} "
                     f"blocks")
        del g
    for k in sums.values():
        k["bound"] = bound(k["bytes"], k["flops"])
    say(phase, f"K1 bitwise equal to plain and to phase_a_model on each of "
               f"the frame's {len(queries)} queries: " + "; ".join(parts)
        + "; sums over the queries: " + ", ".join(
            f"{n} kernel {k['ms']:.3f} ms plain {k['plain_ms']:.3f} ms "
            f"bound {k['bound'][0]:.4f} ms ({k['bound'][1]})"
            for n, k in (("K1", sums["k1"]), ("K2", sums["k2"]))))
    return sums


def pathtracer_frame_setup(rt, dev):
    """The benchmark configuration PT_CONFIG's frame at PT_SIDE^2: the
    heightfield with its materials in runs of triangles, its cluster
    size, two lights, camera and render settings."""
    import dataclasses
    from pathlib import Path
    from raycore_tpu_torch.render import pathtracer as tp
    cfg = json.loads((Path(__file__).resolve().parent / PT_CONFIG)
                     .read_text())
    m, li, c, r = (cfg["materials"], cfg["lights"], cfg["camera"],
                   cfg["render"])
    hf = cfg["scene"]["params"]
    mesh = rt.displaced_grid_mesh(n=PT_MESH, extent=hf["extent"],
                                  amplitude=hf["amplitude"], seed=hf["seed"],
                                  device=dev)
    n = mesh.vertices.shape[0]
    mesh = dataclasses.replace(mesh, metadata=(torch.arange(
        n, device=dev) // m["run"]) % len(m["base_color"]))
    scene = rt.build_dense(mesh, cluster_size=cfg["build"]["cluster_size"])
    mats = rt.Materials.create(base_color=m["base_color"],
                               metallic=m["metallic"],
                               roughness=m["roughness"], device=dev)
    lights = rt.PointLights.create(position=li["position"],
                                   intensity=li["intensity"], device=dev)
    cam = rt.Camera.create(position=c["position"], target=c["target"],
                           up=c["up"], fov_deg=c["fov_deg"], device=dev)
    pt = tp.PTConfig(width=PT_SIDE, height=PT_SIDE, spp=r["spp"],
                     bounces=r["bounces"], tile_size=r["tile_size"],
                     eps=r["eps"], background=tuple(r["background"]),
                     compact=r["compact"])
    return scene, mats, lights, cam, pt


def pathtracer_phase(phase, rt, ops_dense, ops_regroup, dispatch, dev,
                     read_counts, zero_counts):
    """The path-traced production frame (tools/tpu_pathtracer_bench.py at
    its defaults, BASELINE config #5) through trace_paths_staged: one
    warm-up frame, then PT_SEEDS frames timed whole with CUDA events (host
    syncs included), each launching exactly K1 and K2 once a query; a
    frame with every query timed on its own (live rays, closest, shadow,
    glue); determinism; the image's range; the closest query of bounce
    PT_ORACLE_BOUNCE against the oracle and its shadow query's occluders;
    K1 and K2 on every query's operands (``frame_kernels``); stage 1's
    share of three queries; PT_BATCHES frames in one batch against their
    solo frames. Returns the launches of one frame and K1's and K2's
    numbers on the frame's queries."""
    from raycore_tpu_torch.render import pathtracer as tp
    t_phase = time.perf_counter()
    scene, mats, lights, cam, cfg = pathtracer_frame_setup(rt, dev)
    R = cfg.width * cfg.height * cfg.spp
    n_queries = 2 * cfg.bounces
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    frame = lambda s: tp.trace_paths_staged(scene, mats, lights, cam, gen(s),
                                            cfg)
    warm, warm_ms = timed_call(lambda: frame(PT_SEEDS[0]))
    imgs, times, per_frame = {}, [], None
    for s in PT_SEEDS:
        zero_counts()
        imgs[s], ms = timed_call(lambda: frame(s))
        times.append(ms)
        per_frame = read_counts(f"path-traced frame seed {s}",
                                ["phase_a", "refine_pairs",
                                 "regroup_sweep"])
        if (per_frame["phase_a"], per_frame["refine_pairs"],
                per_frame["regroup_sweep"]) != (n_queries,) * 3:
            raise AssertionError(f"frame seed {s}: launches {per_frame}, "
                                 f"expected K1, K7 and K2 once a query "
                                 f"({n_queries} queries)")
    med = statistics.median(times)
    say(phase, f"trace_paths_staged {cfg.width}x{cfg.height}, "
               f"{cfg.bounces} bounces, {scene.n_prims} tris (C=256): "
               f"warm-up {warm_ms:.1f} ms; frames (seeds {PT_SEEDS}) "
               f"{' '.join(f'{x:.2f}' for x in times)} ms, median "
               f"{med:.2f} ms, range {min(times):.2f}-{max(times):.2f} ms, "
               f"{n_queries * R / med / 1e3:.3f} Mrays/s over {n_queries} x "
               f"{R} submitted rays; launches a frame {per_frame}; on "
               f"{torch.cuda.get_device_name(0)}")

    # Determinism and the image's range.
    if not torch.equal(warm, imgs[PT_SEEDS[0]]):
        raise AssertionError("seed 0 rendered twice differs")
    img = imgs[PT_SEEDS[0]]
    if (img.shape != (cfg.height, cfg.width, 3)
            or not bool(torch.isfinite(img).all())
            or float(img.min()) < 0 or float(img.max()) > 1
            or float(img.mean()) <= 0.01):
        raise AssertionError(f"image {tuple(img.shape)}: min "
                             f"{float(img.min())} max {float(img.max())} "
                             f"mean {float(img.mean())}")

    # Every query on its own: the dispatch functions wrapped with a sync
    # on each side.
    with kept_queries(dispatch) as queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detail = frame(PT_SEEDS[0])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    if not torch.equal(detail, warm):
        raise AssertionError("the per-query frame differs from seed 0's")
    if len(queries) != n_queries:
        raise AssertionError(f"{len(queries)} queries, expected {n_queries}")
    kept = {(i // 2, q["kind"]): q for i, q in enumerate(queries)}
    prev, parts = t0, []
    for b in range(cfg.bounces):
        c, sh = kept[b, "closest"], kept[b, "shadow"]
        glue = (c["t0"] - prev) + (sh["t0"] - c["t1"])
        parts.append(f"bounce {b}: live {c['live']} closest "
                     f"{(c['t1'] - c['t0']) * 1e3:.2f} ms, shadow rays "
                     f"{sh['live']} {(sh['t1'] - sh['t0']) * 1e3:.2f} ms, "
                     f"glue {glue * 1e3:.2f} ms")
        prev = sh["t1"]
    say(phase, f"per query (synced on each side; frame "
               f"{(t_end - t0) * 1e3:.1f} ms): " + "; ".join(parts)
        + f"; after the last query {(t_end - prev) * 1e3:.2f} ms")

    # The bounce's closest query against the oracle, its shadow query's
    # occluders against the exact test.
    crays, cres = (kept[PT_ORACLE_BOUNCE, "closest"][k]
                   for k in ("rays", "out"))
    live = torch.nonzero(crays.t_max >= 0).squeeze(1)
    rng = np.random.default_rng(SEED + phase)
    idx = live[torch.as_tensor(rng.choice(live.numel(), min(
        PT_ORACLE, live.numel()), replace=False), device=dev)]
    srays_o = rt.Ray.create(crays.o[idx], crays.d[idx])
    ref = rt.closest_hit_brute(scene.prims, srays_o)
    got = cres.map(lambda a: a[idx])
    o64, d64 = crays.o[idx], crays.d[idx]
    edge = torch.zeros(idx.numel(), dtype=torch.bool, device=dev)
    for r in (ref, got):
        m = edge_margin(scene.prims.vertices[r.prim_idx.clamp_min(0).long()],
                        o64, d64)
        edge |= r.hit & (m.abs() <= PT_EDGE)
    n_hit, n_tie, only_ref, only_got = check_hits(
        ref, got, f"bounce {PT_ORACLE_BOUNCE} vs oracle", edge=edge,
        max_only_ref=PT_EDGE_FLIPS, max_only_got=PT_EDGE_FLIPS)
    srays, occ = (kept[PT_ORACLE_BOUNCE, "shadow"][k]
                  for k in ("rays", "out"))
    genuine, t_occ, u, v = occluder_t(scene.prims, occ, srays)
    near_edge = occluder_t(scene.prims, occ, srays, EDGE_ROUNDING_SLACK)[0]
    n_fake = int((~genuine).sum())
    if int((~genuine & ~near_edge).sum()) or n_fake > FAKE_OCCLUDERS_MAX:
        raise AssertionError(f"bounce {PT_ORACLE_BOUNCE} shadow rays: "
                             f"{n_fake} occluders the exact test rejects")
    say(phase, f"bounce {PT_ORACLE_BOUNCE} closest query vs brute oracle: "
               f"{idx.numel()} sampled live rays, {n_hit} hits agree, "
               f"{n_tie} prim ties, {only_ref} hit only in the oracle and "
               f"{only_got} only in the port, all within {PT_EDGE} of an "
               f"edge; its shadow query: {int(occ.hit.sum())} occluded of "
               f"{int((srays.t_max >= 0).sum())} live, {n_fake} occluders "
               f"the exact test rejects at slack 1e-4, each within "
               f"{EDGE_ROUNDING_SLACK}")

    # K1 and K2 on every query's own operands.
    kernels = frame_kernels(phase, rt, ops_dense, ops_regroup, scene,
                            queries)

    # Stage 1 against the whole query, on the primary rays and the oracle
    # bounce's incoherent rays, and on bounce 0's shadow rays (median of 3
    # each, CUDA events).
    split = []
    for b, kind in ((0, "closest"), (PT_ORACLE_BOUNCE, "closest"),
                    (0, "shadow")):
        qrays = kept[b, kind]["rays"]
        query = rt.closest_hit if kind == "closest" else rt.any_hit
        if kind == "shadow":      # any_hit's stage 1 runs with t_min = 0
            qrays = rt.Ray.create(qrays.o, qrays.d, t_max=qrays.t_max)
        po, pd, ptmin, ptmax, _, G, TILE = ops_regroup._swept_batch(
            qrays, 2048, 32)[:7]
        q_ms = cuda_ms(lambda: query(scene, qrays), 3)
        st1 = lambda: ops_regroup._stage1_cm_core(scene, po, pd, ptmin,
                                                  ptmax, TILE, G, 16)
        counts = st1()[3]
        st1_ms = cuda_ms(st1, 3)
        split.append(f"bounce {b} {kind}: query {q_ms:.2f} ms, stage 1 "
                     f"{st1_ms:.2f} ms ({st1_ms / q_ms:.0%}); "
                     f"{counts[0]} coarse pairs, {counts[1]} subgroup pairs, "
                     f"{counts[2]} blocks")
    say(phase, "queries alone: " + "; ".join(split))
    del queries, kept

    # PT_BATCHES frames in one batch: every query F x R rays.
    for F in PT_BATCHES:
        seeds = list(range(F))
        for s in seeds:
            if s not in imgs:
                imgs[s] = frame(s)
        batch = lambda: tp.trace_paths_staged_batch(
            scene, mats, lights, cam, [gen(s) for s in seeds], cfg)
        _, bw_ms = timed_call(batch)
        b_times = []
        for _ in range(2):
            out, ms = timed_call(batch)
            b_times.append(ms)
        for f, s in enumerate(seeds):
            err = float((out[f] - imgs[s]).abs().max())
            if err > 1e-6:
                raise AssertionError(f"batch F={F} frame {f} differs from "
                                     f"its solo frame by {err}")
        del out
        bmed = statistics.median(b_times)
        say(phase, f"trace_paths_staged_batch F={F} ({F * R} rays a query): "
                   f"warm-up {bw_ms:.1f} ms, "
                   f"{' / '.join(f'{x:.2f}' for x in b_times)} ms "
                   f"({n_queries * F * R / bmed / 1e3:.3f} Mrays/s, "
                   f"{bmed / F:.2f} ms a frame against {med:.2f} solo); each "
                   f"frame within 1e-6 of its solo frame; allocated at most "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    say(phase, f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=per_frame, **kernels)


def consumers_phase(phase, rt, ops_dense, dispatch, dev, read_counts,
                    zero_counts):
    """The renderers and analyses on the card against their CPU twins
    with the same draws (drawn on the CPU, moved to the card): on the
    room, render_staged, trace_paths_staged plain and textured,
    render_step_mts, the simple.py kernels, hits_from_grid,
    get_illumination and view_factors; collide_instances on
    particle_scene's manager; a trace_paths_staged frame on a
    displaced grid below 2^19 rays (K1, K3, K4), each kernel held to its
    plain version and its model on every query of the card's frame.
    Integer outputs equal; images under the image rule (render/parity.py)
    at atol 3e-5 (the wavefront renderers) or 1e-5 (the path tracer)."""
    from raycore_tpu_torch.analysis import kernels as t_ak
    from raycore_tpu_torch.render import mts_renderer as t_mts
    from raycore_tpu_torch.render import pathtracer as t_pt
    from raycore_tpu_torch.render import simple as t_simple
    from raycore_tpu_torch.render import wavefront as t_wf
    from raycore_tpu_torch.render.parity import (Recorder, check_images,
                                                 cpu_draws)
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    with cpu_draws():
        rooms = {d: rt.example_scene(device=d) for d in (dev, cpu)}
        gen = lambda s: torch.Generator(device=cpu).manual_seed(s)
        W, H = CONSUMER_SIDE
        results = []

        def both(name, fn, atol, fanout=None, recorded=True, spp=1):
            """fn(device) on the card and on the CPU, recorded; the image
            rule on the two images."""
            recs, imgs = {}, {}
            for d in (dev, cpu):
                recs[d] = Recorder(fanout)
                if recorded:
                    with recs[d].recording_port():
                        imgs[d] = fn(d)
                else:
                    imgs[d] = fn(d)
            out = check_images(
                imgs[cpu], imgs[dev], atol,
                recs[cpu].queries if recorded else None,
                recs[dev].queries if recorded else None, spp=spp)
            results.append(f"{name} max abs {out['max_abs']:.3g}, "
                           f"{out['n_past']} pixels past {atol:g}")
            return imgs

        n_lights = rooms[dev][2].position.shape[0]
        wcfg = rt.RenderConfig(width=W, height=H, spp=1, tile_size=1024)
        both("render_staged", lambda d: t_wf.render_staged(
            *rooms[d], gen(1), wcfg), 3e-5, {"any": n_lights})
        pw, ph, pb = CONSUMER_PT
        pcfg = t_pt.PTConfig(width=pw, height=ph, spp=1, bounces=pb,
                             tile_size=256)
        both("trace_paths_staged", lambda d: t_pt.trace_paths_staged(
            *rooms[d], gen(2), pcfg), 1e-5)
        checker = np.indices((8, 8)).sum(0) % 2
        tex = np.stack([checker, 1 - checker, np.ones_like(checker)],
                       -1).astype(np.float32)

        def textured(d):
            s = rt.MultiTypeSet(device=d)
            h = s.store_texture(tex)
            refs = torch.full((6,), -1, dtype=torch.int32, device=d)
            refs[0] = h
            return t_pt.trace_paths_staged(*rooms[d], gen(3), pcfg,
                                           pool=s.get_static().textures,
                                           tex_refs=refs)
        both("trace_paths_staged textured", textured, 1e-5)

        def mts(d):
            sset = t_mts.default_material_set(device=d).get_static()
            scene, _, lights, cam = rooms[d]
            return t_mts.render_step_mts(scene, sset, lights, cam, gen(4),
                                         wcfg)
        both("render_step_mts", mts, 3e-5, recorded=False)
        simple = [("depth", t_simple.depth_kernel, {}, None, 1),
                  ("normal", t_simple.normal_kernel, {}, None, 1),
                  ("shadow", t_simple.shadow_kernel,
                   {"light_radius": 0.6, "n_shadow": 4}, None, 2),
                  ("multi_light", t_simple.multi_light_kernel, "lights",
                   {"any": n_lights}, 1),
                  ("reflective", t_simple.reflective_kernel, "lights",
                   {"any": n_lights}, 1)]
        for name, kernel, kw, fanout, spp in simple:
            def run(d, kernel=kernel, kw=kw, spp=spp):
                scene, mats, lights, cam = rooms[d]
                extra = (dict(lights=lights, materials=mats)
                         if kw == "lights" else kw)
                return t_simple.trace(kernel, scene, cam, width=W, height=H,
                                      spp=spp, gen=gen(5), tile_size=512,
                                      **extra)
            # The soft shadows' query rows are light samples of each path
            # (S, R), which the recorder does not map: images only.
            both(f"simple.{name}", run, 3e-5, fanout,
                 recorded=name != "shadow", spp=spp)

        # The analyses: integer outputs equal.
        down = (0.0, 0.0, -1.0)
        hits = {d: t_ak.hits_from_grid(rooms[d][0], down, grid_size=64)
                for d in (dev, cpu)}
        if not torch.equal(hits[dev].hit.cpu(), hits[cpu].hit):
            raise AssertionError("hits_from_grid: hit masks differ")
        n_bins = int(rooms[cpu][0].prims.metadata.shape[0])
        illum = {d: t_ak.get_illumination(rooms[d][0], down, grid_size=64,
                                          n_bins=n_bins)
                 for d in (dev, cpu)}
        if not torch.equal(illum[dev].cpu(), illum[cpu]):
            raise AssertionError("get_illumination: counts differ")
        vf = {}
        for d in (dev, cpu):
            # tests/test_analysis.py's two facing quads.
            quads = [rt.plane_mesh(center=(0, 0, z), u=(1, 0, 0),
                                   v=(0, 1, 0), metadata=m, device=d)
                     for z, m in ((0.0, [0, 1]), (1.0, [2, 3]))]
            mgr = rt.TLAS(device=d)
            for q in quads:
                mgr.push(q)
            tris = rt.Triangle(**{f: torch.cat([getattr(q, f)
                                                for q in quads])
                                  for f in quads[0].__dataclass_fields__})
            vf[d] = t_ak.view_factors(mgr.sync(), tris, gen(6),
                                      rays_per_triangle=256, n_bins=4,
                                      ray_batch=128)
        if not torch.equal(vf[dev].cpu(), vf[cpu]):
            raise AssertionError(f"view_factors differ: "
                                 f"{(vf[dev].cpu() - vf[cpu]).abs().max()}")
        coll = {}
        for d in (dev, cpu):
            mgr, _, _ = rt.particle_scene(CONSUMER_PARTICLES, device=d)
            coll[d] = rt.collide_instances(mgr.sync())
        if (coll[dev].num_contacts != coll[cpu].num_contacts
                or not torch.equal(coll[dev].contacts.cpu(),
                                   coll[cpu].contacts)):
            raise AssertionError("collide_instances: pairs differ")
        results.append(
            f"hits_from_grid {int(hits[dev].hit.sum())} hits, illumination "
            f"{int(illum[dev].sum())} counts, view_factors "
            f"{int(vf[dev].sum())} counts, collide_instances "
            f"{coll[dev].num_contacts} pairs of {CONSUMER_PARTICLES} "
            f"particles: equal")

        # A displaced grid below 2^19 rays: the worklist engines.
        n, C, gw, gh = CONSUMER_GRID
        grids = {d: rt.build_dense(rt.displaced_grid_mesh(n=n, device=d),
                                   cluster_size=C) for d in (dev, cpu)}
        gm = {d: (rt.Materials.create(np.full((2 * n * n, 3), 0.6,
                                              np.float32), device=d),
                  rt.PointLights.create([[0.0, 0, 5.0]], [[20.0, 20, 20]],
                                        device=d),
                  rt.Camera.create(position=(0, -3, 2.5), target=(0, 0, 0),
                                   device=d)) for d in (dev, cpu)}
        gcfg = t_pt.PTConfig(width=gw, height=gh, spp=1, bounces=2,
                             tile_size=256)
        launches, queries = {}, []

        def grid_frame(d):
            if d != dev:
                return t_pt.trace_paths_staged(grids[d], *gm[d], gen(7),
                                               gcfg)
            zero_counts()
            with kept_queries(dispatch) as kept:
                img = t_pt.trace_paths_staged(grids[d], *gm[d], gen(7),
                                              gcfg)
            launches.update(read_counts(
                "grid frame", ["phase_a", "worklist_sweep",
                               "occlusion_sweep"]))
            queries[:] = kept
            return img
        both(f"trace_paths_staged grid n={n} C={C} {gw}x{gh}", grid_frame,
             1e-5)
        results.append(f"the grid frame's launches {launches}")
    say(phase, "card against CPU: " + "; ".join(results))

    # The grid frame's kernels on each of its queries' own operands, at
    # the ray tile dispatch gives its tile_size.
    tile = dispatch._worklist_tile(gcfg.tile_size)
    sweeps = []
    for i, q in enumerate(queries):
        label = f"grid frame bounce {i // 2} {q['kind']} ({q['live']} live): "
        if q["kind"] == "closest":
            k = worklist_sweep_phase(phase, ops_dense, grids[dev], q["rays"],
                                     tile=tile, label=label)
            sweeps.append(f"K3 {k['ms']:.3f} ms plain {k['plain_ms']:.3f}")
        else:
            k = occlusion_sweep_phase(ops_dense, grids[dev], q["rays"],
                                      phase=phase, tile=tile, label=label)
            sweeps.append(f"K4 {k['ms']:.3f} ms plain {k['plain_ms']:.3f}")
    say(phase, f"the grid frame's {len(queries)} queries: "
               + "; ".join(sweeps) + f"; phase wall "
               f"{time.perf_counter() - t_phase:.1f} s")


# --- phases 23-27: the rest of the public surface ---------------------------

def counted_query(what, fn, want, read_counts, zero_counts):
    """(fn(), ms, launches): one call between CUDA events, with every
    kernel's count set to 0 just before it and read just after; each
    kernel in ``want`` must have launched exactly once and no other."""
    zero_counts()
    out, ms = timed_call(fn)
    launches = read_counts(what, want)
    if any(launches[k] != 1 for k in want):
        raise AssertionError(f"{what}: launches {launches}, expected each of "
                             f"{want} once")
    return out, ms, launches


def as_ids(res, ids):
    """``res``'s hit and t with ``ids`` as its prim identity, for
    ``check_hits``."""
    return SimpleNamespace(hit=res.hit, t=res.t, prim_idx=ids)


def rounds_phase(phase, rt, ops_dense, scene, o, d, head, diag, shadow,
                 read_counts, zero_counts):
    """The rounds engine (closest_hit_dense at its defaults, tile 2048, 4
    clusters a round) on the headline: one counted query (K1 once), the
    median and range of 3 more, the rounds taken; K1 bit for bit against
    its plain version on this query's operands, and its times and bound;
    the hits against phase 6's regrouped result under the engine contract
    with ROUNDS_TIE as the tie bound (the rounds engine reports the
    featurized t, not the exact recompute) and phase 7's x == y rule, and
    a 4096-ray oracle sample; any_hit_dense on phase 11's 1M shadow rays
    against the regrouped any_hit under phase 11's rule; the query on a
    shuffled copy of the grid, Morton-sorted and un-permuted, against the
    plain query. Returns K1's entry for the kernels line."""
    from raycore_tpu_torch.accel import dense as dense_mod
    rays = rt.Ray.create(o, d)
    R = o.shape[0]
    res, first_ms, launches = counted_query(
        "closest_hit_dense", lambda: rt.closest_hit_dense(scene, rays),
        ["phase_a"], read_counts, zero_counts)
    times = [timed_call(lambda: rt.closest_hit_dense(scene, rays))[1]
             for _ in range(3)]
    _, rounds = dense_mod._dense_query(scene, rays, tile=2048,
                                       select_per_round=4, max_rounds=1024)
    med = statistics.median(times)
    off_diag = int((~res.hit & ~diag).sum())
    say(phase, f"closest_hit_dense {R} rays: first {first_ms:.1f} ms, then "
               f"{' '.join(f'{t:.1f}' for t in times)} ms, median {med:.1f} "
               f"ms ({R / med / 1e3:.3f} Mrays/s), range "
               f"{min(times):.1f}-{max(times):.1f} ms, {rounds} rounds of 4 "
               f"clusters a tile; launches {launches}; hit_frac "
               f"{float(res.hit.float().mean())} ({off_diag} misses off the "
               f"x == y line)")
    if off_diag or not bool(torch.isfinite(res.t).all()):
        raise AssertionError(f"rounds engine: {off_diag} misses off the "
                             f"x == y line or a t that is not finite")

    stats, bounds, ek, k1_err, k1_slow = phase_a_check(
        "K1 rounds engine", ops_dense, scene, ops_dense.flat_rays(rays), 2048)
    k1_ms = graph_ms(lambda: ops_dense.phase_a(stats, bounds), 5)
    k1_plain_ms = cuda_ms(lambda: ops_dense.phase_a_plain(stats, bounds), 5,
                          inner=10)
    k1_bound = bound(nbytes(stats, bounds, ek), ek.numel() * K1_PAIR_FLOPS)
    ref = SimpleNamespace(hit=head[0], t=head[1], prim_idx=head[2])
    n_both, n_tie, only_reg, only_rounds = check_hits(
        ref, res, "rounds vs regrouped", edge=diag,
        max_only_ref=DIAG_PORT_MISSES_MAX, max_only_got=DIAG_PORT_MISSES_MAX,
        tie=ROUNDS_TIE)
    same = int((res.hit & ref.hit & (res.t == ref.t)
                & (res.prim_idx == ref.prim_idx)).sum())
    say(phase, f"K1 {tuple(ek.shape)} bitwise equal to plain and model "
               f"({k1_slow} pairs on the plain arithmetic), kernel "
               f"{k1_ms:.4f} ms plain {k1_plain_ms:.4f} ms bound "
               f"{k1_bound[0]:.4f} ms ({k1_bound[1]}); vs the regrouped "
               f"query: {n_both} both hit, {n_tie} prim ties within "
               f"{ROUNDS_TIE}, {same} with equal t bits and prim; on the "
               f"line {only_reg} hit only in the regrouped engine and "
               f"{only_rounds} only in the rounds engine")
    oracle_sample_phase(phase, rt, scene, o, d, res, diag, ROUNDS_TIE,
                        np.random.default_rng(SEED + phase))

    # Occlusion on phase 11's shadow rays.
    occ, a_ms, a_launches = counted_query(
        "any_hit_dense", lambda: rt.any_hit_dense(scene, shadow),
        ["phase_a"], read_counts, zero_counts)
    reg = rt.any_hit(scene, shadow)
    genuine, t_occ, _, _ = occluder_t(scene.prims, occ, shadow)
    near_edge = occluder_t(scene.prims, occ, shadow, EDGE_ROUNDING_SLACK)[0]
    fake = ~genuine
    if int((fake & ~near_edge).sum()) or int(fake.sum()) > FAKE_OCCLUDERS_MAX:
        raise AssertionError(f"any_hit_dense: {int(fake.sum())} occluders the "
                             f"exact test rejects at slack 1e-4, "
                             f"{int((fake & ~near_edge).sum())} also at "
                             f"{EDGE_ROUNDING_SLACK}")
    n_flip, n_near = shadow_oracle(rt, scene, shadow, occ, t_occ,
                                   np.random.default_rng(SEED + phase))
    reg_genuine, reg_t, _, _ = occluder_t(scene.prims, reg, shadow)
    flips = occ.hit != reg.hit
    explained = fake | ~reg_genuine | (t_occ < NEAR_SURFACE_T) \
        | (reg_t < NEAR_SURFACE_T)
    if int((flips & ~explained).sum()) or int(flips.sum()) > ANY_FLIPS_MAX:
        raise AssertionError(f"any_hit_dense vs the regrouped any_hit: "
                             f"{int(flips.sum())} hit-mask differences (at "
                             f"most {ANY_FLIPS_MAX}), "
                             f"{int((flips & ~explained).sum())} away from "
                             f"an edge and the surface")
    say(phase, f"any_hit_dense on {shadow.o.shape[0]} shadow rays: "
               f"{a_ms:.1f} ms, launches {a_launches}, occluded "
               f"{float(occ.hit.float().mean()):.6f}; {int(fake.sum())} "
               f"occluders within {EDGE_ROUNDING_SLACK} of the triangle; "
               f"sample vs oracle {n_flip} differences ({n_near} near the "
               f"surface); vs the regrouped any_hit {int(flips.sum())} "
               f"hit-mask differences, each at an edge or the surface")

    # Sort a shuffled grid, query, un-permute.
    perm = torch.as_tensor(np.random.default_rng(SEED + phase).permutation(R),
                           device=o.device)
    shuf = rt.Ray.create(o[perm], d[perm])
    (srt, inv), sort_ms = timed_call(lambda: rt.morton_sort_rays(
        shuf, scene.root_aabb[0], scene.root_aabb[1]))
    # closest_hit_dense's body, which also gives the rounds taken.
    (sres, s_rounds), s_ms = timed_call(lambda: dense_mod._dense_query(
        scene, srt, tile=2048, select_per_round=4, max_rounds=1024))
    back = torch.argsort(perm)
    got = sres.map(lambda a: a[inv][back])
    s_both, s_tie, _, _ = check_hits(res, got, "Morton-sorted shuffled grid",
                                     tie=2e-6)
    s_same = int(((got.hit == res.hit) & (got.t == res.t)
                  & (got.prim_idx == res.prim_idx)).sum())
    say(phase, f"shuffled grid: morton_sort_rays {sort_ms:.1f} ms, query "
               f"{s_ms:.1f} ms ({s_rounds} rounds: a 2048-ray tile of the "
               f"sorted order can straddle a jump of the Morton curve); "
               f"un-permuted: equal hit masks, {s_both} hits, "
               f"{s_tie} prim ties at equal t, {s_same} rows with equal t "
               f"bits and prim")
    return {"name": "phase_a", "route": "cuda",
            "source": "raycore_tpu_torch/csrc/phase_a.cu",
            "replaces": "raycore_tpu/ops/pallas_dense.py:445",
            "path": "rounds engine, headline",
            "launches": launches["phase_a"], "max_abs_err": k1_err,
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1], "library_ms": None}


def bvh4_phase(phase, rt, mesh, o, d, diag):
    """The BVH4 layer on the 1M heightfield: build_blas4 timed cold and
    warm, its rows equal to a CPU collapse of the same BVH2 rows;
    closest_hit4 and any_hit4 on every BVH4_STRIDE-th headline ray
    (65,536) against the binary traversal on the same BLAS (equal hit
    masks, t and prim up to exact ties) and a 4096-ray oracle sample,
    each timed once beside the binary traversal."""
    from raycore_tpu_torch.accel import wide

    def build():
        torch.cuda.synchronize()
        t = time.perf_counter()
        b4 = rt.build_blas4(mesh)
        torch.cuda.synchronize()
        return b4, (time.perf_counter() - t) * 1e3

    _, cold = build()
    b4, warm = build()
    blas = rt.build_blas(mesh)
    c4, c_ms = timed_call(lambda: rt.collapse_blas(blas))
    t = time.perf_counter()
    cpu_rows = wide._collapse(blas.nodes.cpu())
    cpu_s = time.perf_counter() - t
    for got, what in ((b4.nodes4, "build_blas4"), (c4.nodes4, "collapse")):
        if not torch.equal(got.cpu(), cpu_rows):
            raise AssertionError(f"BVH4 {what} rows differ from the CPU "
                                 f"collapse in {int((got.cpu() != cpu_rows).sum())}"
                                 f" entries")
    say(phase, f"build_blas4 on {mesh.vertices.shape[0]} tris: cold "
               f"{cold:.1f} ms warm {warm:.1f} ms (the collapse alone "
               f"{c_ms:.2f} ms on the card, {cpu_s:.2f} s on the CPU); "
               f"nodes4 {tuple(b4.nodes4.shape)} equal to the CPU collapse")

    sub = slice(None, None, BVH4_STRIDE)
    so, sd = o[sub].contiguous(), d[sub].contiguous()
    srays = rt.Ray.create(so, sd)
    n = so.shape[0]
    r4, ms4 = timed_call(lambda: rt.closest_hit4(b4, srays))
    a4, msa = timed_call(lambda: rt.any_hit4(b4, srays))
    static = rt.blas_to_static_tlas(blas)
    r2, ms2 = timed_call(lambda: rt.closest_hit(static, srays))
    n_both, n_tie, b_ref, b_got = check_hits(
        r2, r4, "closest_hit4 vs traversal", edge=diag[sub],
        max_only_ref=DIAG_PORT_MISSES_MAX, max_only_got=DIAG_PORT_MISSES_MAX,
        tie=2e-6)
    if not torch.equal(a4.hit, r4.hit):
        raise AssertionError(f"any_hit4: {int((a4.hit != r4.hit).sum())} "
                             f"hit-mask differences from closest_hit4")
    sdiag = diag[sub]
    rng = np.random.default_rng(SEED + phase)
    pick = np.union1d(rng.choice(n, min(4096, n), replace=False),
                      torch.nonzero(sdiag).squeeze(1).cpu().numpy())
    idx = torch.as_tensor(pick, device=o.device)
    ref = rt.closest_hit_brute(mesh, rt.Ray.create(so[idx], sd[idx]))
    got = r4.map(lambda a: a[idx])
    o_both, o_tie, o_ref, o_got = check_hits(
        as_ids(ref, ref.triangle.metadata), as_ids(got, got.triangle.metadata),
        "closest_hit4 vs oracle", edge=sdiag[idx],
        max_only_ref=DIAG_PORT_MISSES_MAX,
        max_only_got=DIAG_ORACLE_MISSES_MAX, tie=2e-6)
    rate = lambda ms: n / ms / 1e3
    say(phase, f"{n} rays: closest_hit4 {ms4:.1f} ms ({rate(ms4):.4f} "
               f"Mrays/s), any_hit4 {msa:.1f} ms ({rate(msa):.4f} Mrays/s), "
               f"binary traversal on the same BLAS {ms2:.1f} ms "
               f"({rate(ms2):.4f} Mrays/s); vs the traversal {n_both} both "
               f"hit, {n_tie} prim ties, on the x == y line {b_ref} hit only "
               f"in the traversal and {b_got} only in BVH4; any_hit4's mask equal to "
               f"closest_hit4's; vs oracle on {idx.numel()} rays "
               f"({int(sdiag[idx].sum())} on the x == y line) {o_both} both "
               f"hit, {o_tie} ties, {o_ref} only in the oracle and {o_got} "
               f"only in BVH4 on the line")


def fill_contract(accel, meshes):
    """tests/test_contract.py's scene: a sphere, and a box moved 3 along x
    with instance_id 7."""
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    accel.push(meshes[0], None)
    accel.push(meshes[1], tr, instance_id=7)
    return accel


def instanced_tlas(rt, dev):
    """Phase 20's instances pushed into a TLAS at their first
    positions."""
    bases, centers = instanced_inputs(rt, dev)
    mgr = rt.TLAS(device=dev)
    for i, c in enumerate(centers):
        m = np.eye(3, 4, dtype=np.float32)
        m[:, 3] = c
        mgr.push(bases[i % len(bases)], m)
    return mgr


def surface_phase(phase, rt, dev, scene, mesh, rays):
    """The accel protocol, the transport records and the IO on the card:
    both accels on the contract scene (they must agree); trace_closest_hits
    on the 256-instance StaticTLAS against the oracle on the world soup;
    save_scene/load_scene of the 1M headline DenseScene (tables and the
    headline query bit for bit); load_obj (native) of the headline mesh
    written as OBJ with %.9g, and build_dense on it (tables bit for
    bit)."""
    import os
    import tempfile
    xs = torch.linspace(-1.5, 4.0, 256, device=dev)
    X, Y = torch.meshgrid(xs, torch.linspace(-1.2, 1.2, 128, device=dev),
                          indexing="ij")
    co = torch.stack([X, Y, torch.full_like(X, -4.0)], -1).reshape(-1, 3)
    cd = torch.tensor([0.0, 0.0, 1.0], device=dev).expand_as(co).contiguous()
    crays = rt.Ray.create(co, cd)
    meshes = (rt.sphere_mesh(radius=1.0, n_theta=12, n_phi=24, device=dev),
              rt.box_mesh(p_min=(-0.5, -0.5, -0.5), p_max=(0.5, 0.5, 0.5),
                          device=dev))
    tl = fill_contract(rt.TLASAccel(device=dev), meshes)
    br = fill_contract(rt.BruteAccel(device=dev), meshes)
    a, b = tl.closest_hit(crays), br.closest_hit(crays)
    soup = br.sync()[0]
    # The TLAS names a BLAS's sorted prim; its metadata (the face index,
    # ascending in each mesh) finds the row of the brute soup.
    n0 = meshes[0].vertices.shape[0]
    inst = a.instance_idx.long().clamp_min(0)
    local = torch.where(
        inst == 0, torch.searchsorted(meshes[0].metadata, a.triangle.metadata),
        n0 + torch.searchsorted(meshes[1].metadata, a.triangle.metadata))
    c_both, c_tie, c_bad = instanced_check(
        "TLASAccel vs BruteAccel", b, a, b.prim_idx.long().where(b.hit, -1),
        torch.where(a.hit, local, -1), soup, co, cd)
    if not torch.equal(a.instance_idx[a.hit & b.hit],
                       b.instance_idx[a.hit & b.hit]):
        raise AssertionError("the accels name different instances")
    occ_t, occ_b = tl.any_hit(crays), br.any_hit(crays)
    if not (torch.equal(occ_t.hit, a.hit) and torch.equal(occ_b.hit, b.hit)):
        raise AssertionError("an accel's any_hit mask differs from its "
                             "closest_hit's")
    if tl.wait_for_gpu() is not tl or br.wait_for_gpu() is not br:
        raise AssertionError("wait_for_gpu is not chainable")
    say(phase, f"TLASAccel and BruteAccel on the contract scene, {co.shape[0]}"
               f" rays: {c_both} both hit, {c_tie} ties, {c_bad} "
               f"disagreements at an edge; equal instances; any_hit masks "
               f"equal to closest_hit's; world bounds "
               f"{np.asarray(tl.world_bound()).tolist()} / "
               f"{np.asarray(br.world_bound()).tolist()}")

    mgr = instanced_tlas(rt, dev)
    static = mgr.sync()
    io_, id_ = instanced_frame_rays(INSTANCED_SIDE, dev)
    sub = slice(None, None, INSTANCED_TRAVERSAL_STRIDE)
    trays = rt.RTRay.from_rays(rt.Ray.create(io_[sub].contiguous(),
                                             id_[sub].contiguous()))
    tr_res, tr_ms = timed_call(lambda: rt.trace_closest_hits(static, trays))
    n = trays.origin.shape[0]
    if trays.pack().shape != (n, 8):
        raise AssertionError("RTRay.pack has the wrong shape")
    soup, _ = rt.flatten_world_triangles(mgr)
    n_real = torch.tensor([mgr._blas[r.blas_slot].n_prims
                           for r in mgr._instances], device=dev)
    soup_off = torch.cumsum(n_real, 0) - n_real
    idx = torch.as_tensor(np.random.default_rng(SEED + phase).choice(
        n, min(4096, n), replace=False), device=dev)
    so, sd = trays.origin[idx], trays.direction[idx]
    oracle = rt.closest_hit_brute(soup, rt.Ray.create(so, sd))
    got = SimpleNamespace(hit=tr_res.hit[idx], t=tr_res.t[idx])
    got_rows = torch.where(got.hit, soup_off[tr_res.instance_id[idx].long()
                                             .clamp_min(0)]
                           + tr_res.primitive_id[idx].long(), -1)
    t_both, t_tie, t_bad = instanced_check(
        "trace_closest_hits vs oracle", oracle, got,
        oracle.prim_idx.long().where(oracle.hit, -1), got_rows, soup, so, sd)
    meta = soup.metadata[got_rows.clamp_min(0)]
    custom_ok = torch.equal(tr_res.instance_custom_index[idx],
                            torch.where(got.hit, meta, 0))
    if not custom_ok:
        raise AssertionError("trace_closest_hits: instance_custom_index is "
                             "not the hit triangle's metadata")
    say(phase, f"trace_closest_hits on the {INSTANCED_COUNT}-instance "
               f"StaticTLAS, {n} rays: {tr_ms:.1f} ms ({n / tr_ms / 1e3:.4f} "
               f"Mrays/s); {idx.numel()}-ray sample vs the oracle on "
               f"{soup.vertices.shape[0]} world triangles: {t_both} both "
               f"hit, {t_tie} ties, {t_bad} disagreements at an edge; "
               f"instance_custom_index is the hit triangle's metadata "
               f"(instance_id 0 inherits)")
    del mgr, static, soup

    tables = ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
              "prims_hot", "root_aabb")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "headline.npz")
        _, save_s = timed_call(lambda: rt.save_scene(path, scene))
        size = os.path.getsize(path)
        loaded, load_s = timed_call(lambda: rt.load_scene(path, device=dev))
        for k in tables:
            if not torch.equal(getattr(loaded, k), getattr(scene, k)):
                raise AssertionError(f"load_scene: {k} differs")
        for k in ("vertices", "normals", "tangents", "uv", "metadata"):
            if not torch.equal(getattr(loaded.prims, k),
                               getattr(scene.prims, k)):
                raise AssertionError(f"load_scene: prims.{k} differs")
        want, got = rt.closest_hit(scene, rays), rt.closest_hit(loaded, rays)
        for k in ("hit", "t", "prim_idx", "instance_idx", "barycentric"):
            if not torch.equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"the loaded scene's headline query "
                                     f"differs in {k}")
        del loaded, want, got
        say(phase, f"save_scene of the headline DenseScene: {size / 1e6:.1f}"
                   f" MB in {save_s / 1e3:.2f} s; load_scene {load_s / 1e3:.2f}"
                   f" s; tables and prims bit for bit, the headline query "
                   f"(rt.closest_hit) on the loaded scene bit for bit with "
                   f"the built scene's")

        obj = os.path.join(tmp, "headline.obj")
        v = mesh.vertices.reshape(-1, 3).cpu().numpy()
        t = time.perf_counter()
        with open(obj, "w") as f:
            f.write(("v %.9g %.9g %.9g\n" * v.shape[0])
                    % tuple(v.ravel().tolist()))
            f.write(("f %d %d %d\n" * (v.shape[0] // 3))
                    % tuple(range(1, v.shape[0] + 1)))
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        tris = rt.load_obj(obj, native=True, device=dev)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t
        if not torch.equal(tris.vertices, mesh.vertices):
            raise AssertionError("load_obj: vertices differ from the mesh's")
        built = rt.build_dense(tris, cluster_size=scene.cluster_size)
        for k in tables:
            if not torch.equal(getattr(built, k), getattr(scene, k)):
                raise AssertionError(f"build_dense on the loaded OBJ: {k} "
                                     f"differs")
        say(phase, f"load_obj (native) of the headline mesh as OBJ "
                   f"({os.path.getsize(obj) / 1e6:.1f} MB, written in "
                   f"{write_s:.2f} s): {parse_s:.2f} s; build_dense on it "
                   f"gives the headline's tables bit for bit")


def classifier_phase(phase, rt, scene, o, d):
    """The two-phase classifier on the headline: CLASSIFIER_TILES tiles of
    2048 rays drawn with a seed, each against every cluster its phase-A
    entry keeps, at bf16 (classify_block: both operands rounded to
    bfloat16, summed in float32) and at bf16x3 (three bf16 products of
    split operands, classify with EPS_BF16X3). Sound against float64
    truth on the same float32 features: no truly accepted candidate
    rejected, no certain candidate truly rejected, certain t intervals
    bracketing the exact t, and every ray that ray_verdict does not call
    ambiguous naming the exact winner. Reports the share of ambiguous
    rays (the census number) in each mode."""
    from raycore_tpu_torch.accel.dense import (INVD_COLS, _first_argmin,
                                               ray_features)
    from raycore_tpu_torch.ops import dense as ops_dense
    from raycore_tpu_torch.ops import two_phase as tp
    TILE, C = 2048, scene.cluster_size
    po, pd, ptmin, ptmax = ops_dense.pad_rays(o, d, torch.zeros_like(o[:, 0]),
                                              torch.full_like(o[:, 0],
                                                              float("inf")),
                                              TILE)
    n_tiles = po.shape[0] // TILE
    entry = ops_dense.phase_a_entry(
        po, ray_features(po, pd)[:, INVD_COLS], ptmin, ptmax,
        scene.cluster_min, scene.cluster_max, TILE)
    tiles = np.random.default_rng(SEED + phase).choice(
        n_tiles, CLASSIFIER_TILES, replace=False)
    bf = tp._bf16
    e = tp.EDGE_EPS
    counts = {m: dict(amb=0, decided=0) for m in ("bf16", "bf16x3")}
    rays = cands = 0
    t0 = time.perf_counter()
    for tile in tiles.tolist():
        rows = slice(tile * TILE, (tile + 1) * TILE)
        cids = torch.nonzero(torch.isfinite(entry[tile])).squeeze(1)
        phi = ray_features(po[rows], pd[rows])
        feats = scene.tri_feats[cids]                     # (n_c, 16, 4C)
        n_c = cids.numel()
        tmin = ptmin[rows]
        tmax = ptmax[rows]
        q64 = torch.einsum("rf,kfq->rkq", phi.double(), feats.double())
        det = q64[..., :C]
        u, v, t = (q64[..., k * C:(k + 1) * C] / det for k in (1, 2, 3))
        acc = ((u >= -e) & (u <= 1 + e) & (v >= -e) & (u + v <= 1 + e)
               & (t >= tmin[:, None, None]) & (t <= tmax[:, None, None])
               & (det != 0)).reshape(TILE, -1)
        t_acc = torch.where(acc, t.reshape(TILE, -1), float("inf"))
        exact_hit = torch.isfinite(t_acc.amin(1))
        exact_best = _first_argmin(t_acc)
        keys = (cids[:, None] * C + torch.arange(C, device=o.device)).reshape(
            -1).expand(TILE, -1).to(torch.int32)
        for mode in ("bf16", "bf16x3"):
            if mode == "bf16":
                outs = [tp.classify_block(phi, feats[k], tmin, tmax, C)
                        for k in range(n_c)]
                cls = [torch.stack([x[i] for x in outs], 1).reshape(TILE, -1)
                       for i in range(4)]
            else:
                f2 = feats.permute(1, 0, 2).reshape(feats.shape[1], -1)
                ah, bh = bf(phi), bf(f2)
                al, bl = bf(phi - ah), bf(f2 - bh)
                q = ah @ bh + ah @ bl + al @ bh
                s = bf(phi.abs()) @ bf(f2.abs())
                cls = [x.reshape(TILE, -1) for x in tp.classify(
                    q.reshape(TILE, n_c, 4 * C), s.reshape(TILE, n_c, 4 * C),
                    tmin[:, None, None], tmax[:, None, None], C,
                    eps=tp.EPS_BF16X3)]
            certain, possible, t_lo, t_hi = cls
            tt = t.reshape(TILE, -1)
            if bool((acc & ~possible).any()) or bool((certain & ~acc).any()):
                raise AssertionError(f"classifier ({mode}): unsound on tile "
                                     f"{tile}")
            ct = certain & acc
            if bool((t_lo.double()[ct] > tt[ct]).any()) or bool(
                    (t_hi.double()[ct] < tt[ct]).any()):
                raise AssertionError(f"classifier ({mode}): a certain t "
                                     f"interval misses the exact t")
            _, winner, amb = tp.ray_verdict(certain, possible, t_lo, t_hi,
                                            keys)
            ok = ~amb
            w = ok & exact_hit
            if not torch.equal(winner[w].long(),
                               keys[0].long()[exact_best[w]]) or bool(
                    (ok & ~exact_hit & (winner >= 0)).any()):
                raise AssertionError(f"classifier ({mode}): a decided ray "
                                     f"names another winner than the exact "
                                     f"test")
            counts[mode]["amb"] += int(amb.sum())
            counts[mode]["decided"] += int(((~possible) | certain).sum())
        rays += TILE
        cands += TILE * n_c * C
    desc = "; ".join(
        f"{m}: {c['amb']} ambiguous rays ({c['amb'] / rays:.4f}), "
        f"{c['decided'] / cands:.4f} of candidates decided"
        for m, c in counts.items())
    say(phase, f"classifier on {len(tiles)} headline tiles ({rays} rays, "
               f"{cands} (ray, triangle) candidates from phase A's finite "
               f"entries, {cands / rays:.0f} a ray): sound against float64 "
               f"truth, every decided ray names the exact winner; {desc}; "
               f"{time.perf_counter() - t0:.1f} s")


def sharding_phase(phase, rt, dev, o, d, head, diag):
    """Ray sharding in SHARD_RANKS gloo ranks on the one card, spawned by
    ``python -m raycore_tpu_torch.parallel.dryrun`` (NCCL takes one rank
    a card): distributed_closest_hit_dense on the 1M headline (2^19 rays
    a rank, each rank K1 and K2 once on its first call), its gathered
    result against phase 6's single-process regrouped query under the
    contract; distributed_illumination and distributed_closest_hit on
    the dry run's two-instance StaticTLAS, the histogram and the hits
    equal to the single-process query's. Two ranks on one card share its
    SMs: their times say nothing about scaling."""
    import json
    import os
    import tempfile
    from raycore_tpu_torch.parallel.dryrun import small_scene
    tlas = small_scene(dev)
    n_bins = int(tlas.prims.metadata.shape[0])
    xs = np.linspace(-1.5, 4.5, 64, dtype=np.float32)
    X, Y = np.meshgrid(xs, np.linspace(-1.5, 1.5, 64, dtype=np.float32),
                       indexing="ij")
    to = np.stack([X, Y, np.full_like(X, -4.0)], -1).reshape(-1, 3)
    td = np.broadcast_to(np.float32([0, 0, 1]), to.shape).copy()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/headline.npz", o=o.cpu().numpy(), d=d.cpu().numpy())
        np.savez(f"{tmp}/tlas.npz", o=to, d=td)
        headline = {"dense": "displaced_grid_mesh", "kw": HEADLINE_MESH,
                    "cluster_size": HEADLINE_C}
        cases = [
            {"name": "dense", "fn": "closest_hit_dense", "scene": headline,
             "rays": f"{tmp}/headline.npz", "reps": 3,
             "kwargs": {"tile": 2048, "subgroup": 32, "spb": 16}},
            {"name": "illumination", "fn": "illumination",
             "scene": {"small_tlas": True}, "rays": f"{tmp}/tlas.npz",
             "kwargs": {"n_bins": n_bins, "tile_size": 4096}},
            {"name": "closest_hit", "fn": "closest_hit",
             "scene": {"small_tlas": True}, "rays": f"{tmp}/tlas.npz",
             "kwargs": {"tile_size": 4096}}]
        with open(f"{tmp}/cases.json", "w") as f:
            json.dump(cases, f)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m",
                        "raycore_tpu_torch.parallel.dryrun", "--ranks",
                        str(SHARD_RANKS), "--device", str(dev),
                        "--workdir", tmp, "--cases", f"{tmp}/cases.json"],
                       check=True, timeout=SHARD_TIMEOUT_S,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t
        outs = torch.load(f"{tmp}/outputs.pt", weights_only=False)
    per_rank = [o_["dense"]["launches"] for o_ in outs]
    if any(l != {"phase_a": 1, "regroup_sweep": 1} for l in per_rank):
        raise AssertionError(f"sharded dense query: launches per rank "
                             f"{per_rank}, expected K1 and K2 once each")
    out = outs[0]["dense"]
    got = SimpleNamespace(
        hit=torch.as_tensor(out["hit"], device=dev),
        t=torch.as_tensor(out["t"], device=dev),
        prim_idx=torch.as_tensor(out["prim_idx"], device=dev))
    ref = SimpleNamespace(hit=head[0], t=head[1], prim_idx=head[2])
    n_both, n_tie, _, _ = check_hits(ref, got, "sharded vs single process",
                                     edge=diag, tie=2e-6)
    same = int(((got.hit == ref.hit) & (got.t == ref.t)
                & (got.prim_idx == ref.prim_idx)).sum())
    for o_ in outs[1:]:
        if not all(np.array_equal(o_["dense"][k], out[k])
                   for k in ("hit", "t", "prim_idx")):
            raise AssertionError("the ranks hold different gathered results")
    tres = rt.closest_hit(tlas, rt.Ray.create(torch.as_tensor(to, device=dev),
                                              torch.as_tensor(td,
                                                              device=dev)))
    idx = tres.triangle.metadata.to(torch.int32).clamp(0, n_bins - 1).long()
    hist = torch.zeros(n_bins, device=dev).index_add_(0, idx,
                                                      tres.hit.float())
    if not np.array_equal(outs[0]["illumination"]["hist"], hist.cpu().numpy()):
        raise AssertionError("sharded histogram differs from the single "
                             "process's")
    ch = outs[0]["closest_hit"]
    n_t = to.shape[0]
    if not (np.array_equal(ch["hit"][:n_t], tres.hit.cpu().numpy())
            and np.array_equal(ch["t"][:n_t], tres.t.cpu().numpy())):
        raise AssertionError("sharded closest_hit differs from the single "
                             "process's")
    fmt = lambda xs: " ".join(f"{x:.1f}" for x in xs)
    say(phase, f"{SHARD_RANKS} gloo ranks on one card, {o.shape[0]} headline "
               f"rays ({o.shape[0] // SHARD_RANKS} a rank): launches per "
               f"rank {per_rank}; calls (the first replicates the scene) "
               + "; ".join(f"rank {o_['dense']['rank']} {fmt(o_['dense']['ms'])}"
                           f" ms, replicate {o_['dense']['replicate_ms']:.1f}"
                           f" ms" for o_ in outs)
               + f"; vs the single-process regrouped query {n_both} both "
               f"hit, {n_tie} prim ties, {same} rows bit for bit; "
               f"illumination histogram ({n_bins} bins, "
               f"{int(hist.sum())} hits) and closest_hit on {n_t} rays "
               f"equal to the single process's; subprocess wall {wall:.1f} "
               f"s. Two ranks share one card: these times say nothing about "
               f"scaling")



def two_light_shadow_rays(rt, shadow):
    """Shadow rays from the origins of ``shadow`` (the headline surface,
    lifted) toward one of REFINE_LIGHTS each, drawn per ray, with t_max
    the distance to the light: neighbouring rays change direction octant
    about every other ray, so the engine sweeps them in octant order."""
    o = shadow.o
    rng = np.random.default_rng(SEED + 28)
    pick = torch.as_tensor(rng.integers(0, len(REFINE_LIGHTS), o.shape[0]),
                           device=o.device)
    light = torch.tensor(REFINE_LIGHTS, device=o.device)[pick]
    to = light - o
    dist = to.norm(dim=1)
    return rt.Ray.create(o, to / dist[:, None], t_max=dist)


def refine_phase(phase, rt, ops_dense, ops_regroup, scene, cases,
                 read_counts, zero_counts):
    """K7 on each of ``cases`` ((name, rays, occlusion)): the query
    through its entry point (K1, K7 and K2 once each, no other kernel);
    then, on the operands the engine builds (any_hit's rays with t_min
    forced to 0, ``_swept_batch`` at tile 2048 in subgroups of 32, the
    order the engine sweeps), K1 bitwise against its plain version and
    its model (``phase_a_check``), its worklist and the subgroup stats,
    and K7 once, bitwise against ``refine_pairs_plain`` and
    ``refine_pairs_model``. K7's time from a CUDA graph of 50 calls and
    from calls launched from the host back to back, its plain version's,
    and its bound: the output and each input read once at the HBM
    bandwidth, or K7_ENTRY_FLOPS an entry at the float32 peak. Returns
    one entry a case for the kernels line."""
    out = []
    for name, rays, occlusion in cases:
        zero_counts()
        (rt.any_hit if occlusion else rt.closest_hit)(scene, rays)
        torch.cuda.synchronize()
        want = ["phase_a", "refine_pairs", "regroup_sweep"]
        counts = read_counts(f"{name} query", want)
        if any(counts[k] != 1 for k in want):
            raise AssertionError(f"{name} query: launches {counts}, "
                                 f"expected {want} once each")
        if occlusion:
            rays = rt.Ray.create(rays.o, rays.d, t_max=rays.t_max)
        po, pd, ptmin, ptmax, _, G, TILE, order = ops_regroup._swept_batch(
            rays, 2048, 32)[:8]
        _, _, ek, _, slow = phase_a_check(f"K1 {name}", ops_dense, scene,
                                          (po, pd, ptmin, ptmax), TILE)
        cids, tids = ops_dense.build_worklist(ek.T)
        del ek
        tbl = ops_regroup.ray_table(po, pd, ptmin, ptmax, G)
        stats = ops_dense.bundle_stats(po, ops_regroup.table_invd(tbl),
                                       ptmin, ptmax, G)
        del tbl
        SPT, n_tiles = TILE // G, po.shape[0] // TILE
        args = (stats, tids, cids, scene.cluster_min, scene.cluster_max,
                SPT, n_tiles)
        zero_counts()
        got = ops_regroup.refine_pairs(*args)
        torch.cuda.synchronize()
        if read_counts(f"K7 {name}", ["refine_pairs"])["refine_pairs"] != 1:
            raise AssertionError(f"K7 {name}: not launched once")
        bits = got.view(torch.int32)
        for ref, what in ((ops_regroup.refine_pairs_plain, "plain version"),
                          (ops_regroup.refine_pairs_model, "model")):
            diff = int((bits != ref(*args).view(torch.int32)).sum())
            if diff:
                raise AssertionError(f"K7 {name}: {diff} of {got.numel()} "
                                     f"entries differ from the {what}")
        P = tids.shape[0]
        kept = int(torch.isfinite(got).sum())
        fn = lambda: ops_regroup.refine_pairs(*args)
        ms = graph_ms(fn, 5)
        host_ms = cuda_ms(fn, 5, inner=20)
        plain_ms = cuda_ms(lambda: ops_regroup.refine_pairs_plain(*args), 5)
        b = bound(nbytes(got, stats, tids, cids, scene.cluster_min,
                         scene.cluster_max),
                  got.numel() * K7_ENTRY_FLOPS)
        swept = "octant order" if order is not None else "as given"
        say(phase, f"K7 refine_pairs, {name} ({swept}): P {P} coarse "
                   f"pairs x SPT {SPT} = {got.numel()} entries, bitwise "
                   f"equal to plain and to "
                   f"refine_pairs_model; kept {kept} "
                   f"({100.0 * kept / max(got.numel(), 1):.3f}%); K1 "
                   f"bitwise on the same rays ({slow} pairs on its plain "
                   f"arithmetic); kernel {ms:.4f} ms on the card "
                   f"({host_ms:.4f} ms a call launched from the host), "
                   f"plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]})")
        out.append({"path": name, "launches": counts["refine_pairs"],
                    "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                    "bound": b})
        del got, args, stats, tids, cids, po, pd, ptmin, ptmax
    return out


# The benchmark's instanced cell, whose frame K8 serves.
AFFINE_CELL = "dynamic-128.refit-1m"


def affine_phase(phase, dev, read_counts, zero_counts):
    """K8 at AFFINE_CELL's shapes, its loop set up and warmed by the
    benchmark's harness (seed SEED): one frame through the loop, which
    must launch K1, K7 and K2 once, K8's refresh once and its local rays
    twice and no other kernel; then, on the operands that frame builds,
    the refresh (the next frame's transforms), pair mode (stage 1's
    (subgroup, instance) pairs at tile 2048, G 32) and ray mode (the
    frame's rays and winners' instances, -1 on a miss), each once and
    bitwise against its plain version, its time from a CUDA graph of 50
    calls and from calls launched from the host back to back, its plain
    version's, and its bound: its bytes once at the HBM bandwidth (each
    output written and each row's inputs read once). Returns one entry a
    path for the kernels line."""
    from pathlib import Path

    from cardbench.core import harness
    from cardbench.core.specs import Specs
    from raycore_tpu_torch.ops import affine as ops_affine
    from raycore_tpu_torch.ops import instanced as ops_inst
    from raycore_tpu_torch.ops import regroup as ops_regroup
    _, loop = harness.prepare(Specs([Path(__file__).resolve().parent]),
                              AFFINE_CELL, SEED, dev)
    zero_counts()
    res = loop.call(0)
    torch.cuda.synchronize()
    want = ["phase_a", "refine_pairs", "regroup_sweep", "instance_refresh",
            "local_rays"]
    counts = read_counts(f"{AFFINE_CELL} frame", want)
    if [counts[k] for k in want] != [1, 1, 1, 1, 2]:
        raise AssertionError(f"{AFFINE_CELL} frame: launches {counts}, "
                             f"expected K1, K7, K2 and K8's refresh once "
                             f"and its local rays twice")
    scene = loop.scene
    tf = torch.as_tensor(loop.transforms[1], device=dev)
    po, pd, ptmin, ptmax, R0, G, TILE = ops_regroup._padded_batch(
        loop.rays, 2048, 32)
    s1 = ops_inst._stage1_inst_core(scene, po, pd, ptmin, ptmax, TILE, G, 16)
    Q, I = s1.qsub.shape[0], tf.shape[0]
    inst = res.instance_idx.long()
    cases = [
        ("refresh", ops_affine.refresh_tables,
         ops_affine.refresh_tables_plain,
         (tf, scene.inst_local_min, scene.inst_local_max), "instance_refresh",
         I * (48 + 24 + 48 + 24), f"{I} instances"),
        ("stage 1 pair rows", ops_affine.local_rays,
         ops_affine.local_rays_plain,
         (scene.inst_inv, s1.qinst, po, pd, (s1.qsub, ptmin, ptmax, G)),
         "local_rays", Q * G * (32 + 32) + Q * 8 + I * 48,
         f"{Q} pairs x G {G} = {Q * G} rows"),
        ("finalize rays", ops_affine.local_rays, ops_affine.local_rays_plain,
         (scene.inst_inv, inst, po[:R0], pd[:R0]), "local_rays",
         R0 * (24 + 8 + 24) + I * 48, f"{R0} rays"),
    ]
    out = []
    for name, fn, plain, args, counter, n_bytes, rows in cases:
        zero_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        if read_counts(f"K8 {name}", [counter])[counter] != 1:
            raise AssertionError(f"K8 {name}: not launched once")
        for g, w in zip(got, plain(*args)):
            diff = int((g.reshape(-1).view(torch.int32)
                        != w.reshape(-1).view(torch.int32)).sum())
            if diff or g.shape != w.shape:
                raise AssertionError(f"K8 {name}: {diff} of {g.numel()} "
                                     f"values differ from the plain version")
        call = lambda: fn(*args)
        ms = graph_ms(call, 5)
        host_ms = cuda_ms(call, 5, inner=20)
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        b = bound(n_bytes, 0)
        say(phase, f"K8 instance_affine, {AFFINE_CELL} {name} ({rows}): "
                   f"bitwise equal to plain; kernel {ms:.4f} ms on the card "
                   f"({host_ms:.4f} ms a call launched from the host), plain "
                   f"{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]})")
        out.append({"path": f"{AFFINE_CELL} frame, {name}", "launches": 1,
                    "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                    "bound": b})
    say(phase, f"K8 launches a frame: {counts['instance_refresh']} refresh + "
               f"{counts['local_rays']} local rays; sums: kernel "
               f"{sum(k['ms'] for k in out):.4f} ms, plain "
               f"{sum(k['plain_ms'] for k in out):.3f} ms, bound "
               f"{sum(k['bound'][0] for k in out):.4f} ms")
    loop.release()
    return out


if __name__ == "__main__":
    sys.exit(main())
