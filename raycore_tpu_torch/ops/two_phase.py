"""The two-phase interval classifier (counterpart of
``raycore_tpu/ops/two_phase.py``).

A reduced-precision pass computes the featurized Möller–Trumbore
quantities q = phi @ F with each operand rounded to bfloat16 and the
products summed in float32, and the magnitude sums s = |phi| @ |F| the
same way. With |q' - q| <= s * eps per output (``EPS_BF16`` for one pass,
``EPS_BF16X3`` for the three-pass split-operand scheme; the JAX module
states the margin argument), ``classify`` proves each candidate CERTAIN
(accepted, with a t interval), REJECTED, or leaves it POSSIBLE; a
candidate whose det interval holds 0 stays POSSIBLE. ``ray_verdict``
marks a ray ambiguous unless its best certain candidate's t upper bound
beats every other candidate's t lower bound; only ambiguous rays need the
exact test.

``classify`` and ``ray_verdict`` are elementwise steps and reductions,
bit for bit with the JAX package on equal inputs: the sign of det keeps a
zero's sign and a NaN, the maxima against 0 give +0 as XLA's do, and the
argmin takes the first index. ``classify_block`` rounds both operands to
bfloat16 explicitly and multiplies in float32, which is what a TPU's
DEFAULT precision does and what the margin argument assumes.
"""
from __future__ import annotations

import torch

from ..accel.dense import EDGE_EPS, _first_argmin

EPS_BF16 = 2.0 ** -7       # one bf16 pass
EPS_BF16X3 = 2.0 ** -14    # three bf16 passes on split operands


def _sign(x):
    """``jnp.sign``: -0 and NaN map to themselves (``torch.sign`` gives
    +0 for both)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _max0(x):
    """``jnp.maximum(x, 0.0)``: +0 for -0 and for negatives, NaN kept."""
    return torch.where((x > 0) | torch.isnan(x), x, 0.0)


def classify(q, s, t_min, t_max, C: int, edge_eps: float = EDGE_EPS,
             eps: float = EPS_BF16):
    """Classify candidates from the reduced-precision products.

    q: (..., 4C) approximate [det | udet | vdet | tdet] blocks; s: (...,
    4C) magnitude sums, same layout; t_min, t_max: (..., 1) per ray.
    Returns (certain, possible, t_lo, t_hi), each (..., C): certain is
    provably accepted with [t_lo, t_hi] bracketing its exact t; possible
    is not provably rejected (certain included); for a possible candidate
    t_lo still bounds any true hit t from below (-inf when the sign of
    det is unknown)."""
    det, udet, vdet, tdet = (q[..., k * C:(k + 1) * C] for k in range(4))
    E_d, E_u, E_v, E_t = (s[..., k * C:(k + 1) * C] * eps for k in range(4))

    s_ok = det.abs() > E_d
    sig = _sign(det)
    a = _max0(det.abs() - E_d)        # |det| lower bound
    b = det.abs() + E_d               # |det| upper bound
    e = edge_eps

    def cond(x_mid, E_x, lo_coef, hi_coef=None):
        """(certainly true, certainly false) of sigma*x >= lo_coef*|det|,
        or of sigma*x <= hi_coef*|det| with hi_coef."""
        x1 = sig * x_mid - E_x
        x2 = sig * x_mid + E_x
        if hi_coef is None:
            lo_hi = torch.maximum(lo_coef * a, lo_coef * b)
            lo_lo = torch.minimum(lo_coef * a, lo_coef * b)
            return x1 >= lo_hi, x2 < lo_lo
        hi_hi = torch.maximum(hi_coef * a, hi_coef * b)
        hi_lo = torch.minimum(hi_coef * a, hi_coef * b)
        return x2 <= hi_lo, x1 > hi_hi

    c1t, c1f = cond(udet, E_u, -e)                      # u >= -e
    c2t, c2f = cond(udet, E_u, None, 1.0 + e)           # u <= 1+e
    c3t, c3f = cond(vdet, E_v, -e)                      # v >= -e
    c4t, c4f = cond(udet + vdet, E_u + E_v, None, 1.0 + e)  # u+v <= 1+e
    c5t, c5f = cond(tdet, E_t, t_min)                   # t >= tmin
    c6t, c6f = cond(tdet, E_t, None, t_max)             # t <= tmax

    certain = s_ok & c1t & c2t & c3t & c4t & c5t & c6t
    rejected = s_ok & (c1f | c2f | c3f | c4f | c5f | c6f)
    possible = ~rejected

    # t = (sigma*tdet) / |det| by endpoint division.
    y1 = sig * tdet - E_t
    y2 = sig * tdet + E_t
    inf = float("inf")
    t_lo = torch.where(y1 >= 0.0, y1 / b, y1 / a)
    t_hi = torch.where(y2 <= 0.0, y2 / b, y2 / a)
    t_lo = torch.where(s_ok, t_lo, -inf)
    t_hi = torch.where(s_ok, t_hi, inf)
    # a == 0 with y >= 0 divides to inf or NaN: take the conservative end.
    t_lo = torch.where(torch.isnan(t_lo), -inf, t_lo)
    t_hi = torch.where(torch.isnan(t_hi), inf, t_hi)
    return certain, possible, t_lo, t_hi


def _bf16(x):
    """float32 values rounded to bfloat16 (to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def classify_block(phi, feats, t_min, t_max, C: int):
    """The one-pass reference path for an (R, 16) ray block against one
    (16, 4C) feature block: both products on bfloat16-rounded operands
    summed in float32, then ``classify``. The products are exact in
    float32 (8-bit significands), so they depend only on the order of
    the sums."""
    q = torch.matmul(_bf16(phi), _bf16(feats))
    s = torch.matmul(_bf16(phi.abs()), _bf16(feats.abs()))
    return classify(q, s, t_min[:, None], t_max[:, None], C)


def ray_verdict(certain, possible, t_lo, t_hi, key_pair):
    """Per-ray ambiguity from per-candidate classifications, all (R, N)
    over a ray's N candidates; ``key_pair`` holds the candidate ids.
    Returns (ub, winner, ambiguous): the best certain t upper bound (+inf
    with no certain hit), the id of that candidate (-1 with none; the
    first on ties), and whether the exact test is needed: another
    possible candidate's t_lo undercuts ub, or possible candidates exist
    and no certain one."""
    inf = float("inf")
    hi = torch.where(certain, t_hi, inf)
    ub = hi.amin(dim=-1)
    win_slot = _first_argmin(hi)
    has_certain = torch.isfinite(ub)
    winner = torch.where(
        has_certain, key_pair.gather(-1, win_slot[..., None])[..., 0], -1)
    lo = torch.where(possible, _max0(t_lo), inf)
    slots = torch.arange(key_pair.shape[-1], device=key_pair.device)
    lo_excl = torch.where(
        has_certain[..., None] & (slots == win_slot[..., None]), inf, lo)
    threat = lo_excl.amin(dim=-1)
    ambiguous = torch.where(has_certain, threat < ub, torch.isfinite(threat))
    return ub, winner, ambiguous
