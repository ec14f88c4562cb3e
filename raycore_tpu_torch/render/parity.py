"""Hold two renders of the same frame to each other: the image rule.

Two renders of one frame with the same random draws (the port on two
devices, or the port and the JAX package) trace rays that differ by
rounding, so a ray that grazes a triangle's edge, or two triangles at
one t, can take different hits, and from there its path goes its own
way. The rule:

- every query of the frame is compared row by row under the engine
  contract (equal hit masks; where both hit, each t within rtol 2e-5 /
  atol 2e-6 of its own ray's float64 intersection with its triangle, and
  a different triangle only at a t tie below 2e-6 relative), rows matched
  by the path they belong to; a path whose row differs is explained only
  by a t tie or by a ray within ``EDGE`` of a winning triangle's edge
  (float64 barycentric margin), and from then on its later rows are not
  compared;
- a pixel whose colours differ by more than ``atol`` must belong to such
  a path, and at most ``MAX_SHARE`` of the pixels may.

``Recorder`` wraps a dispatch module (``accel/dispatch.py`` of either
package) and keeps each query's rays, results and the path of each row;
a renderer's compaction order reaches it through an order hook
(``pathtracer_order``, ``wavefront_order``) on the stage that computes
it. ``cpu_draws`` makes the port's renders on the card draw the numbers
of their CPU twins. NumPy on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import List, Optional, Sequence

import numpy as np
import torch

EDGE = 1e-4
T_RTOL, T_ATOL, TIE = 2e-5, 2e-6, 2e-6
MAX_SHARE = 0.01


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Query:
    kind: str            # "closest" or "any"
    o: np.ndarray        # (N, 3) float64
    d: np.ndarray        # (N, 3) float64
    hit: np.ndarray      # (N,) bool
    t: np.ndarray        # (N,) float64 (closest only; zeros for any)
    prim: np.ndarray     # (N,) int64
    inst: np.ndarray     # (N,) int64
    verts: np.ndarray    # (N, 3, 3) float64 winner in world space
    paths: np.ndarray    # (N,) int64


def world_vertices(scene, prim, inst) -> np.ndarray:
    """(N, 3, 3) float64 world-space vertices of triangles ``prim`` of
    instances ``inst`` (a StaticTLAS: BLAS-local prims under the
    instance's transform) or of a DenseScene's ``prims``; zeros for -1."""
    prim = np.asarray(prim, np.int64)
    ok = prim >= 0
    verts = _np(scene.prims.vertices).astype(np.float64)
    if hasattr(scene, "unified_nodes"):
        ii = np.clip(np.asarray(inst, np.int64), 0, None)
        blas = _np(scene.instances.blas_index).astype(np.int64)[ii]
        rows = _np(scene.blas_prims_offset).astype(np.int64)[blas] + prim
        v = verts[np.where(ok, rows, 0)]
        m = _np(scene.instances.transform).astype(np.float64)[ii]
        v = np.einsum("nij,nkj->nki", m[:, :, :3], v) + m[:, None, :, 3]
    else:
        v = verts[np.where(ok, prim, 0)]
    return np.where(ok[:, None, None], v, 0.0)


def _mt64(v, o, d):
    """Möller–Trumbore in float64 of rays (N, 3) against triangles
    (N, 3, 3) without range tests: (t, u, w); NaN where parallel."""
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    s1 = np.cross(d, e2)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 1.0 / (s1 * e1).sum(1)
        dv = o - v[:, 0]
        s2 = np.cross(dv, e1)
        return ((e2 * s2).sum(1) * r, (dv * s1).sum(1) * r,
                (d * s2).sum(1) * r)


def edge_margin(v, o, d) -> np.ndarray:
    """min(u, w, 1 - u - w) of rays (N, 3) against triangles (N, 3, 3),
    in float64; NaN where the ray is parallel."""
    _, u, w = _mt64(v, o, d)
    return np.minimum(np.minimum(u, w), 1.0 - u - w)


def pathtracer_order(module):
    """The order hook of a path tracer module (either package): its
    shading stage returns the accumulated compaction order sixth."""
    return module, "_pt_shade_and_sample", lambda out: _np(out[5])


def wavefront_order(module, stage: str = "_shade_reflect_core"):
    """The order hook of a wavefront module (either package; the JAX
    package's staged stage is ``_jit_shade_reflect``): the reflection
    query's rows follow the inverse of the stage's ``inv_order``."""
    return module, stage, lambda s2: np.argsort(_np(s2["inv_order"]),
                                                kind="stable")


class Recorder:
    """Every query made through a dispatch module while ``recording``;
    row i of a query belongs to path ``order[i // fanout]`` (``order``
    None: path i // fanout), ``fanout`` per query kind."""

    def __init__(self, fanout: Optional[dict] = None):
        self.queries: List[Query] = []
        self.order: Optional[np.ndarray] = None
        self.fanout = fanout or {}

    def set_order(self, order) -> None:
        self.order = None if order is None else _np(order).astype(np.int64)

    def _add(self, kind, scene, rays, res):
        try:
            o, d = _np(rays.o), _np(rays.d)
        except Exception:     # a traced value: nothing concrete to keep
            return
        n = o.reshape(-1, 3).shape[0]
        prim = _np(res.prim_idx).reshape(-1).astype(np.int64)
        inst = _np(res.instance_idx).reshape(-1).astype(np.int64)
        hit = _np(res.hit).reshape(-1)
        rows = np.arange(n) // self.fanout.get(kind, 1)
        paths = rows if self.order is None else self.order[rows]
        self.queries.append(Query(
            kind=kind, o=o.reshape(-1, 3).astype(np.float64),
            d=d.reshape(-1, 3).astype(np.float64), hit=hit,
            t=(_np(res.t).reshape(-1).astype(np.float64)
               if kind == "closest" else np.zeros(n)),
            prim=prim, inst=inst,
            verts=world_vertices(scene, np.where(hit, prim, -1), inst),
            paths=paths))

    @contextlib.contextmanager
    def recording(self, disp, orders: Sequence = ()):
        """Record the queries of ``disp.scene_closest_hit`` and
        ``disp.scene_any_hit`` inside the block. Each order hook
        ``(module, stage, order_of)`` wraps ``module.stage`` so that its
        output ``out`` sets the rows' paths to ``order_of(out)``; the
        order starts as None (rows in path order)."""
        saved = disp.scene_closest_hit, disp.scene_any_hit
        stages = [(m, name, getattr(m, name)) for m, name, _ in orders]

        def wrap(fn, kind):
            def recorded(scene, rays, *a, **kw):
                out = fn(scene, rays, *a, **kw)
                self._add(kind, scene, rays, out)
                return out
            return recorded

        def ordered(stage, order_of):
            def wrapped(*a, **kw):
                out = stage(*a, **kw)
                self.set_order(order_of(out))
                return out
            return wrapped

        self.set_order(None)
        disp.scene_closest_hit = wrap(saved[0], "closest")
        disp.scene_any_hit = wrap(saved[1], "any")
        for (m, name, stage), (_, _, order_of) in zip(stages, orders):
            setattr(m, name, ordered(stage, order_of))
        try:
            yield self
        finally:
            disp.scene_closest_hit, disp.scene_any_hit = saved
            for m, name, stage in stages:
                setattr(m, name, stage)

    def recording_port(self):
        """``recording`` on the port's dispatch with the port renderers'
        order hooks: the path tracer's accumulated order, the wavefront
        renderer's reflection order."""
        from ..accel import dispatch
        from . import pathtracer, wavefront
        return self.recording(dispatch, (pathtracer_order(pathtracer),
                                         wavefront_order(wavefront)))


# The port's draw helpers: each takes (generator, ..., device) and
# returns a tensor or a tuple of tensors on that device.
_DRAW_HELPERS = (("render.wavefront", "_pixel_jitter"),
                 ("render.wavefront", "_roughness_draws"),
                 ("render.pathtracer", "_bounce_draws"),
                 ("render.simple", "_primary_jitter"),
                 ("render.simple", "_disk_draws"),
                 ("analysis.kernels", "_batch_draws"),
                 ("core.sampling", "_uniform"))


@contextlib.contextmanager
def cpu_draws():
    """Inside the block every draw helper of the port draws on the CPU
    from the generator it is given (a CPU generator) and moves the
    numbers to the device asked for, so a render on the card and its CPU
    twin, each given a CPU generator seeded alike, draw the same
    numbers."""
    pkg = __name__.rsplit(".", 2)[0]
    spots = [(importlib.import_module(f"{pkg}.{m}"), n)
             for m, n in _DRAW_HELPERS]
    saved = [getattr(m, n) for m, n in spots]

    def moved(fn):
        def drawn(gen, *a):
            out = fn(gen, *a[:-1], torch.device("cpu"))
            dev = a[-1]
            return (tuple(x.to(dev) for x in out) if isinstance(out, tuple)
                    else out.to(dev))
        return drawn

    for (m, n), fn in zip(spots, saved):
        setattr(m, n, moved(fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(spots, saved):
            setattr(m, n, fn)


def _row_differs(a: Query, b: Query, i, j):
    """Rows of two queries that differ under the engine contract, and the
    rows among them that differ at a t tie. The rays of the two renders
    differ by rounding (and may differ in length), so each t is held to
    its own ray's float64 intersection with its triangle (rtol 2e-5,
    atol 2e-6), and two triangles tie where one ray meets both planes
    within 2e-6 of its t."""
    hit_a, hit_b = a.hit[i], b.hit[j]
    differ = hit_a != hit_b
    if a.kind == "any":
        return differ, np.zeros_like(differ)
    both = hit_a & hit_b
    va, vb = a.verts[i], b.verts[j]
    ta64 = _mt64(va, a.o[i], a.d[i])[0]
    tb64 = _mt64(vb, b.o[j], b.d[j])[0]
    t_off = (np.abs(a.t[i] - ta64) > T_ATOL + T_RTOL * np.abs(ta64)) \
        | (np.abs(b.t[j] - tb64) > T_ATOL + T_RTOL * np.abs(tb64))
    other = (a.prim[i] != b.prim[j]) | (a.inst[i] != b.inst[j])
    with np.errstate(invalid="ignore"):
        tie = both & other & (
            (np.abs(_mt64(vb, a.o[i], a.d[i])[0] - ta64)
             <= TIE * np.abs(ta64))
            | (np.abs(_mt64(va, b.o[j], b.d[j])[0] - tb64)
               <= TIE * np.abs(tb64)))
    differ |= both & (t_off | other)
    return differ, tie


def compare_queries(ref: List[Query], got: List[Query]):
    """Walk the two renders' queries in order under the engine contract.
    Returns (the set of paths that diverged, at a t tie or an edge; rows
    compared; rows that differed). Raises AssertionError on a row that
    differs otherwise, or on queries that do not pair up."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(ref)} queries against {len(got)}")
    diverged = np.zeros(0, np.int64)
    n_cmp = n_diff = 0
    for q, (a, b) in enumerate(zip(ref, got)):
        if a.kind != b.kind or a.paths.shape != b.paths.shape:
            raise AssertionError(f"query {q}: {a.kind} of {a.paths.size} "
                                 f"rows against {b.kind} of {b.paths.size}")
        i = np.argsort(a.paths, kind="stable")
        j = np.argsort(b.paths, kind="stable")
        if not np.array_equal(a.paths[i], b.paths[j]):
            raise AssertionError(f"query {q}: the rows' paths differ")
        live = ~np.isin(a.paths[i], diverged)
        i, j = i[live], j[live]
        differ, tie = _row_differs(a, b, i, j)
        n_cmp += i.size
        n_diff += int(differ.sum())
        if differ.any():
            di, dj, dtie = i[differ], j[differ], tie[differ]
            margin = np.fmin(
                np.abs(edge_margin(a.verts[di], a.o[di], a.d[di])),
                np.abs(edge_margin(b.verts[dj], b.o[dj], b.d[dj])))
            # Each side's ray against the other's winner too: a ray that
            # one render missed at an edge has its margin on the other's
            # triangle.
            margin = np.fmin(margin, np.fmin(
                np.abs(edge_margin(b.verts[dj], a.o[di], a.d[di])),
                np.abs(edge_margin(a.verts[di], b.o[dj], b.d[dj]))))
            bad = ~(dtie | (margin <= EDGE))
            if bad.any():
                k = np.nonzero(bad)[0][:4]
                raise AssertionError(
                    f"query {q} ({a.kind}): {int(bad.sum())} rows differ "
                    f"neither at a t tie nor within {EDGE} of an edge: "
                    f"hit {a.hit[di[k]]} / {b.hit[dj[k]]}, t {a.t[di[k]]} "
                    f"/ {b.t[dj[k]]}, prim {a.prim[di[k]]} / "
                    f"{b.prim[dj[k]]}, margin {margin[k]}")
            diverged = np.union1d(diverged, a.paths[di])
    return set(diverged.tolist()), n_cmp, n_diff


def check_images(ref_img, got_img, atol: float, ref_queries=None,
                 got_queries=None, spp: int = 1) -> dict:
    """The image rule: pixels past ``atol`` only on paths that diverged
    at a t tie or an edge (``compare_queries`` on the two renders'
    recorded queries; without recordings no pixel may pass ``atol``), at
    most ``MAX_SHARE`` of the pixels. Images (..., 3) with paths numbered
    pixel-major, ``spp`` paths a pixel. Returns the max abs difference,
    the pixels past atol and the queries' row counts."""
    a = _np(ref_img).astype(np.float64)
    b = _np(got_img).astype(np.float64)
    if a.shape != b.shape or not np.isfinite(b).all():
        raise AssertionError(f"image {b.shape} against {a.shape}, finite "
                             f"{bool(np.isfinite(b).all())}")
    diff = np.abs(a - b).reshape(-1, a.shape[-1]).max(axis=1)
    past = np.nonzero(diff > atol)[0]
    diverged, n_cmp, n_diff = (set(), 0, 0)
    if ref_queries is not None:
        diverged, n_cmp, n_diff = compare_queries(ref_queries, got_queries)
    pixels = {p // spp for p in diverged}
    unexplained = [int(p) for p in past if int(p) not in pixels]
    if unexplained or past.size > MAX_SHARE * diff.size:
        raise AssertionError(
            f"{past.size} of {diff.size} pixels past atol {atol} (at most "
            f"{MAX_SHARE:.0%}), {len(unexplained)} not on a path that "
            f"diverged at a tie or an edge (pixels {unexplained[:8]}); max "
            f"abs {diff.max():.3g}")
    return dict(max_abs=float(diff.max()), n_past=int(past.size),
                rows=n_cmp, rows_differ=n_diff, paths_diverged=len(diverged))
