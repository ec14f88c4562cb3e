"""The plain reference: every ray against every triangle, Möller–Trumbore.

It imports nothing of the program and takes nothing the program made:
the triangles are the generated vertices (world space), the rays the
generated origins, directions and ranges.

For each (ray, triangle) pair Möller–Trumbore's four scalar triple
products are written as dot products of a ray's features
``[d, o, o x d, 1]`` with the triangle's (``n = e1 x e2``):

    det   = -d . n
    t det = o . n - v0 . n
    u det = (o x d) . e2 + d . (v0 x e2)
    v det = -(o x d) . e1 - d . (v0 x e1)

so one matrix product per chunk of triangles gives all four, and the
rest is elementwise. ``precision="float64"`` is the judge. ``"tf32"``
is the control: the same reference with every product's operands rounded
to TF32 (10 explicit mantissa bits, round to nearest even) and summed in
float32, which is what a TF32 tensor-core contraction computes.

A pair is a hit where det != 0, u >= 0, v >= 0, u + v <= 1 and
t_min < t <= t_max. The closest hit is the smallest t (ties: the lowest
triangle index). A hit's depth is how far inside its triangle the ray
passes, min(u, v, 1 - u - v); for occlusion also min(t, t_max - t) over
t_max, so an occluder at either end of the segment is shallow.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits (round
    to nearest, ties to even); infinities and NaNs pass."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def triangle_features(v: torch.Tensor) -> torch.Tensor:
    """(10, 4T) float64 weights of the four products for triangles
    ``v`` (T, 3, 3), columns [det | t det | u det | v det] per triangle."""
    v = v.double()
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    n = torch.linalg.cross(e1, e2)
    T = v.shape[0]
    z3 = torch.zeros_like(n)
    z1 = torch.zeros((T, 1), dtype=v.dtype, device=v.device)
    # Rows: d (3), o (3), o x d (3), 1.
    det = torch.cat([-n, z3, z3, z1], 1)
    tdet = torch.cat([z3, n, z3, -(v0 * n).sum(1, keepdim=True)], 1)
    udet = torch.cat([torch.linalg.cross(v0, e2), z3, e2, z1], 1)
    vdet = torch.cat([-torch.linalg.cross(v0, e1), z3, -e1, z1], 1)
    return torch.cat([det, tdet, udet, vdet], 0).T.contiguous()


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(S, 10) float64 features of rays."""
    o, d = o.double(), d.double()
    one = torch.ones((o.shape[0], 1), dtype=o.dtype, device=o.device)
    return torch.cat([d, o, torch.linalg.cross(o, d), one], 1)


def _products(F, W, precision):
    if precision == "float64":
        return F @ W
    if precision == "tf32":
        return round_tf32(F.float()) @ round_tf32(W.float())
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def trace(v, o, d, t_min, t_max, *, occlusion: bool,
          precision: str = "float64", chunk: int = 8192):
    """The reference over triangles ``v`` (T, 3, 3) for rays ``o``, ``d``
    (S, 3) with ranges ``t_min``, ``t_max`` (S,). Returns a dict of
    (S,) tensors: ``hit``, ``t`` (the closest hit's; +inf on a miss),
    ``idx`` (the closest hit's triangle, -1 on a miss), ``bary`` ((S, 2),
    the closest hit's (u, v) at this precision) and ``depth`` (the
    closest hit's depth; with ``occlusion`` the deepest occluder's)."""
    dt = torch.float64 if precision == "float64" else torch.float32
    dev = o.device
    S = o.shape[0]
    F = ray_features(o, d)
    lo = t_min.to(dt)[:, None]
    hi = t_max.to(dt)[:, None]
    best_t = torch.full((S,), float("inf"), dtype=dt, device=dev)
    best_i = torch.full((S,), -1, dtype=torch.long, device=dev)
    best_depth = torch.full((S,), -1.0, dtype=dt, device=dev)
    best_uv = torch.zeros((S, 2), dtype=dt, device=dev)
    deepest = torch.full((S,), -1.0, dtype=dt, device=dev)
    for c0 in range(0, v.shape[0], chunk):
        vc = v[c0:c0 + chunk]
        Tc = vc.shape[0]
        P = _products(F, triangle_features(vc), precision).view(S, 4, Tc)
        det, tdet, udet, vdet = P.unbind(1)
        ok = det != 0
        r = 1.0 / torch.where(ok, det, torch.ones_like(det))
        u, w, t = udet * r, vdet * r, tdet * r
        margin = torch.minimum(torch.minimum(u, w), 1.0 - u - w)
        hit = ok & (margin >= 0) & (t > lo) & (t <= hi)
        if occlusion:
            span = torch.minimum(t, hi - t) / hi
            depth = torch.where(hit, torch.minimum(margin, span),
                                torch.full_like(t, -1.0))
            deepest = torch.maximum(deepest, depth.amax(1))
        tt = torch.where(hit, t, torch.full_like(t, float("inf")))
        ct, ci = tt.min(1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, ci + c0, best_i)
        pick = lambda x: x.gather(1, ci[:, None])[:, 0]
        best_depth = torch.where(better, pick(margin), best_depth)
        best_uv = torch.where(better[:, None],
                              torch.stack([pick(u), pick(w)], 1), best_uv)
    hit = best_i >= 0
    return dict(hit=hit, t=best_t, idx=best_i, bary=best_uv,
                depth=deepest if occlusion else best_depth)


def _named(v, idx, o, d):
    """Möller–Trumbore in float64 of ray i against triangle ``idx[i]``:
    (u, v, t), NaN where the ray is parallel to the triangle or ``idx``
    is out of range."""
    T = v.shape[0]
    valid = (idx >= 0) & (idx < T)
    tri = v[idx.clamp(0, max(T - 1, 0))].double()
    o, d = o.double(), d.double()
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(1)
    ok = valid & (det != 0)
    r = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - tri[:, 0]
    u = (tv * p).sum(1) * r
    q = torch.linalg.cross(tv, e1)
    w = (d * q).sum(1) * r
    t = (e2 * q).sum(1) * r
    nan = torch.full_like(det, float("nan"))
    return tuple(torch.where(ok, x, nan) for x in (u, w, t))


def evaluate(v, idx, o, d):
    """(margin, t) of ray i against triangle ``idx[i]`` of ``v`` in
    float64, margin = min(u, v, 1 - u - v); NaN where the ray is parallel
    to the triangle or ``idx`` is out of range."""
    u, w, t = _named(v, idx, o, d)
    return torch.minimum(torch.minimum(u, w), 1.0 - u - w), t


def barycentric(v, idx, o, d):
    """(S, 2) float64 (u, v) of ray i on triangle ``idx[i]``: the weights
    of its second and third vertices; NaN as in ``evaluate``."""
    u, w, _ = _named(v, idx, o, d)
    return torch.stack([u, w], 1)
