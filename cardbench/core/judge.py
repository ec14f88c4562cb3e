"""The comparison that decides ``correct``.

The program's answers for a sample of rays are held to the float64
reference (``reference/tracer.py``) by up to five numbers, each a widest
gap over the sample, each with its own limit (the cell file's
``check.limits``):

- ``t_gap`` (closest hit only): where both hit, how far the program's t
  lies beyond the nearest hit, (t - t_ref) / t_ref, or 0. A farther
  triangle, or a t too large, reads here; a t nearer than any true hit
  names no true hit and reads in ``claim_gap``.
- ``claim_gap``: where the program reports a hit, how far its answer is
  from what it names. The named triangle is intersected in float64:
  how far outside the triangle the ray passes (-min(u, v, 1 - u - v)),
  and for a closest hit |t - t_named| / t_named; for occlusion how far
  the occluder lies outside (0, t_max), over t_max. An answer that names
  no triangle, or one the ray is parallel to, reads ``UNNAMED``.
- ``missed_by``: where the program reports no hit and the reference
  finds one, the reference hit's depth (``tracer.trace``): a crack at a
  shared edge is shallow, a lost hit deep.
- ``bary_gap`` (closest hit only): where the program reports a hit, how
  far its barycentric (u, v) lies from the named triangle's in float64,
  the larger of the two differences.
- ``tri_gap`` (closest hit only): where the program reports a hit, the
  largest difference between the triangle it returns (vertices, and
  normals where the scene gives them) and the generated triangle it
  names, both in the space the program returns them in. The program
  gathers them unchanged, so its limit is 0.

An answer is judged by what it says: ties between triangles at one t,
and hits an edge's rounding moves to the neighbour, read near 0.

Two extensions let one check judge a loop of several queries and the
work between them (``core/harness.py``'s loop contract):

- A kind per sample. A sample that carries ``occlusion`` is judged by
  that kind, in ``numbers`` and in the control's reference; one without
  it by its loop's ``occlusion``. Closest hits and occlusion answers of
  one loop then sit side by side, each held to its own numbers.
- A loop's own numbers. Where the loop has ``judge(sample, v,
  control=False)``, the numbers it returns join the sample's reading
  (``joined``): each a widest gap over the sample (``widest``), of what
  the loop's call derived from the program's answers against a plain
  float64 reference under ``cardbench/reference/``. The cell's
  ``check.limits`` hold them as they hold the five above; with
  ``control=True`` the loop puts its reference, at TF32 or float32, in
  the program's place (``control.py``), so each limit is set between the
  two readings as the five are.

A sample passes when each of its numbers lies within its limit
(``passes``); a limit that no sample reads fails the combined verdict.
"""
from __future__ import annotations

import math

import torch

from cardbench.reference import tracer

# The reading of a claim that names no triangle (an index out of range,
# or a triangle the ray is parallel to), and of any gap that is not
# finite.
UNNAMED = 1.0e30


def widest(x: torch.Tensor) -> float:
    """The widest of gaps ``x``, 0 where there are none, ``UNNAMED`` for
    one that is not finite."""
    if x.numel() == 0:
        return 0.0
    x = torch.where(torch.isfinite(x), x, torch.full_like(x, UNNAMED))
    return float(x.max().clamp_min(0.0))


def numbers(v, rays, got, *, occlusion: bool, ref=None) -> dict:
    """The judged numbers of answers ``got`` (``hit``, ``idx`` and, for a
    closest hit, ``t``, (S,) each; ``bary`` (S, 2) the program's (u, v);
    ``payload`` (S, P) the returned triangle's numbers and ``want`` (S, P)
    the generated triangle's, NaN where none is named) for ``rays``
    (``o``, ``d``, ``t_min``, ``t_max``) against triangles ``v`` (T, 3,
    3). ``ref`` is the float64 reference's answer when already
    computed."""
    o, d, lo, hi = rays["o"], rays["d"], rays["t_min"], rays["t_max"]
    if ref is None:
        ref = tracer.trace(v, o, d, lo, hi, occlusion=occlusion)
    hit = got["hit"].bool()
    margin, t_named = tracer.evaluate(v, got["idx"].long(), o, d)
    lo, hi = lo.double(), hi.double()
    if occlusion:
        scale = torch.where(torch.isfinite(hi), hi, torch.ones_like(hi))
        outside = torch.maximum(-t_named, t_named - hi) / scale
    else:
        t = got["t"].double()
        outside = torch.maximum((t - t_named).abs() / t_named.abs(),
                                torch.maximum(lo - t_named, t_named - hi)
                                / t_named.abs())
    claim = torch.maximum(-margin, outside)
    out = {}
    if not occlusion:
        both = hit & ref["hit"]
        t_ref = ref["t"].double()
        out["t_gap"] = widest(((got["t"].double() - t_ref)
                               / t_ref.abs())[both])
    out["claim_gap"] = widest(claim[hit])
    if "bary" in got:
        named = tracer.barycentric(v, got["idx"].long(), o, d)
        out["bary_gap"] = widest(
            (got["bary"].double() - named).abs().amax(1)[hit])
    if "payload" in got:
        out["tri_gap"] = widest(
            (got["payload"].double() - got["want"].double()).abs()
            .amax(1)[hit])
    out["missed_by"] = widest(ref["depth"].double()[~hit & ref["hit"]])
    return out


def combine(readings) -> dict:
    """The widest reading of each number over several samples."""
    out = {}
    for r in readings:
        for k, x in r.items():
            out[k] = max(out.get(k, 0.0), x)
    return out


def joined(nums: dict, own: dict) -> dict:
    """A sample's reading with a loop's own numbers joined to it."""
    clash = sorted(set(nums) & set(own))
    if clash:
        raise ValueError(f"a loop's own numbers reuse the names {clash}")
    return {**nums, **{k: float(x) for k, x in own.items()}}


def passes(reading: dict, limits: dict) -> bool:
    """Whether one sample's reading passes: each of its numbers within
    its limit; a number without a limit fails."""
    return all(ok for _, _, ok in verdict(
        reading, {k: x for k, x in limits.items() if k in reading}).values())


def verdict(nums: dict, limits: dict) -> dict:
    """{name: (value, limit, passed)}; a number without a limit, or a
    limit without a number, fails."""
    out = {}
    for k in sorted(set(nums) | set(limits)):
        x, lim = nums.get(k), limits.get(k)
        ok = (x is not None and lim is not None and math.isfinite(x)
              and x <= lim)
        out[k] = (x, lim, ok)
    return out
