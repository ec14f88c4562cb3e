"""The arithmetic of the probes P4 and P1 on the CPU. P4's kernel
(``csrc/block_probe.cu``): its division-free pre-test
(``probe_block_overhead.uv_may_pass``) and the block routed through it
(``run_block_model``). P1's ``loop`` and ``take``: their kernel-order model
in each tier (``gather_probe.run_gather_model``) against the plain version,
and the tier ``gather_tier`` picks at each slice width's limit.

The kernel divides u = udet / det, v = vdet / det and t = tdet / det only
for the (row, lane) pairs the pre-test lets through. So the pre-test must
never refuse a pair that the tool's u and v clauses accept (u >= -e, u <=
1 + e, v >= -e, u + v <= 1 + e, on the IEEE quotients): on adversarial
(det, udet, vdet) triples (+-0, subnormal and 2^+-126-scale dets, +-inf,
NaN, quotients exactly at -e and 1 + e and a few ulps either side, v past
1 + e where u = -e), on random bit patterns and on quotients near the
clauses' edges across exponents. ``run_block_model`` must then equal
``run_block_plain`` bit for bit, on the tool's data and on tables built
around those dets (``torch_adversarial.block_probe_case``). This file
imports no JAX; the card tests hold the kernel to the same plain version
on the same inputs.
"""
import numpy as np
import pytest
import torch

from raycore_tpu_torch.tools import gather_probe as t_gather
from raycore_tpu_torch.tools import probe_block_overhead as t_block
from raycore_tpu_torch.tools._common import EPS, ONE_EPS
from torch_adversarial import (BLOCK_DETS, GATHER_CASES, block_probe_case,
                               gather_case)

F32 = np.float32
INT32_MAX = 0x7FFFFFFF


def _clauses(det, udet, vdet):
    """The tool's clauses on u and v, on the IEEE quotients."""
    u, v = udet / det, vdet / det
    return (u >= -EPS) & (u <= ONE_EPS) & (v >= -EPS) & (u + v <= ONE_EPS)


def _near(det, quotients, rng):
    """det times a quotient from ``quotients``, rounded, moved by -3 to 3
    ulps."""
    with np.errstate(all="ignore"):
        x = (det * rng.choice(np.array(quotients, F32), det.shape)) \
            .astype(F32)
    step = rng.integers(-3, 4, det.shape)
    for k in (1, 2, 3):
        x = np.where(step >= k, np.nextafter(x, F32(np.inf)), x)
        x = np.where(step <= -k, np.nextafter(x, F32(-np.inf)), x)
    return x


EDGES = (-1e-5, 1 + 1e-5, 0.0, -0.0, 1.0, -2e-5, 1 + 2e-5, 0.5, 2.0 ** -20,
         1 + 2.0 ** -20, 1 + 1.5e-5, 1 + 2.5e-5)


def _triples(kind, n=1 << 18, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "adversarial":
        det = rng.choice(np.array(BLOCK_DETS, F32), n)
        udet = _near(det, EDGES, rng)
        vdet = _near(det, EDGES, rng)
        specials = np.array(BLOCK_DETS, F32)
        for x in (udet, vdet):
            x[::13] = rng.choice(specials, x[::13].shape)
    elif kind == "bits":
        raw = rng.integers(0, 2 ** 32, (3, n), dtype=np.uint64)
        det, udet, vdet = raw.astype(np.uint32).view(F32)
    else:
        # Quotients near the clauses' edges, dets across every exponent.
        det = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-149, 128, n)
               * rng.choice([-1, 1], n)).astype(F32)
        udet = _near(det, EDGES, rng)
        vdet = _near(det, EDGES, rng)
    return tuple(torch.as_tensor(np.ascontiguousarray(x))
                 for x in (det, udet, vdet))


@pytest.mark.parametrize("kind", ["adversarial", "bits", "near"])
def test_uv_may_pass_never_refuses_an_accepted_pair(kind):
    det, udet, vdet = _triples(kind)
    may = t_block.uv_may_pass(det, udet, vdet)
    ok = _clauses(det, udet, vdet)
    bad = ok & ~may
    assert not bool(bad.any()), (det[bad][:5], udet[bad][:5], vdet[bad][:5])
    # Not vacuous: it refuses most of what the clauses refuse.
    assert int((~ok & ~may).sum()) > 0.5 * int((~ok).sum())


def test_uv_may_pass_on_special_dets():
    """det +-0 lets only zero numerators through (u = NaN then; any other
    is +-inf); det NaN and NaN numerators are refused (u or v NaN); det
    +-inf refuses no numerator that is not NaN (its bounds are infinite;
    u is +-0 or NaN); an infinite numerator against a finite det is
    refused (u = +-inf); numerators are taken with det's sign."""
    inf, nan = float("inf"), float("nan")
    cases = [  # (det, udet, vdet, may)
        (0.0, 0.0, -0.0, True), (-0.0, 0.0, 0.0, True),
        (0.0, 1e-30, 0.0, False), (-0.0, -3.0, 0.0, False),
        (0.0, 0.0, 2.0 ** -149, False), (nan, 0.5, 0.5, False),
        (1.0, nan, 0.5, False), (1.0, 0.5, nan, False),
        (inf, 5.0, -5.0, True), (-inf, -5.0, 3.0, True),
        (inf, inf, 0.0, True), (-inf, 0.0, -inf, True),
        (1.0, inf, 0.5, False), (-1.0, 0.5, -inf, False),
        (1.0, 0.5, 0.5, True), (-2.0, -1.0, 0.5, False),
        (-2.0, -1.0, -0.5, True), (3.0, -1.0, 0.5, False),
        (2.0 ** -149, 2.0 ** -149, 0.0, True),
        (-(2.0 ** -149), -(2.0 ** -149), -0.0, True),
        (2.0 ** -149, -(2.0 ** -149), 0.0, False),
    ]
    det, udet, vdet, want = (torch.tensor([c[i] for c in cases])
                             for i in range(4))
    assert torch.equal(t_block.uv_may_pass(det, udet, vdet), want.bool())


@pytest.mark.parametrize("scale", [2.0 ** -140, 2.0 ** -126, 2.0 ** -60,
                                   0.37, 1.0, 3.0, 2.0 ** 100, 2.0 ** 127])
def test_uv_may_pass_at_the_clause_edges(scale):
    """Numerators whose IEEE quotient is exactly -e or 1 + e, at both signs
    of det, pass (at subnormal scales, where numerators are coarse, such
    quotients are rare); quotients at -2e and 1 + 2e, past both margins,
    are refused."""
    pretest = t_block.uv_may_pass
    rng = np.random.default_rng(1)
    det = (rng.uniform(1, 2, 4096) * scale * rng.choice([-1, 1], 4096)) \
        .astype(F32)
    t_det = torch.as_tensor(det)
    for edge in (-1e-5, 1 + 1e-5):
        t_num = torch.as_tensor(_near(det, (edge,), rng))
        exact = (t_num / t_det) == torch.tensor(F32(edge))
        assert int(exact.sum()) >= (100 if scale >= 2.0 ** -100 else 0)
        zero = torch.zeros_like(t_num)
        assert bool(pretest(t_det, t_num, zero)[exact].all())
        assert bool(pretest(t_det, zero, t_num)[exact].all())
    with np.errstate(all="ignore"):
        for out in (-2e-5, 1 + 2e-5):
            num = torch.as_tensor((det * F32(out)).astype(F32))
            # Where the numerator is coarse (subnormal), its quotient can
            # round back inside; keep those that stay out.
            q = num.double() / t_det.double()
            live = torch.isfinite(num) & ((q < -1.5e-5) | (q > 1 + 1.5e-5))
            may = pretest(t_det, num, torch.zeros_like(num))
            assert int(live.sum()) >= (100 if scale >= 2.0 ** -100 else 0)
            assert not bool(may[live].any())


def test_margins_are_the_floats_just_past_the_slack():
    """The margins are the float32 values just above e and 1 + e and the
    least at or above M_HI + e."""
    assert t_block.M_LO == float(np.nextafter(F32(EPS), F32(1)))
    assert t_block.M_HI == float(np.nextafter(F32(ONE_EPS), F32(2)))
    assert t_block.M_V >= t_block.M_HI + EPS
    assert float(np.nextafter(F32(t_block.M_V), F32(0))) < t_block.M_HI + EPS


def _tool_case(G, SPB, n_blocks, seed):
    tbl, feats, gen = t_block.make_inputs(n_sub=96, K=12, device="cpu",
                                          seed=seed)
    return tbl[:, :G].contiguous(), feats, gen


@pytest.mark.parametrize("case", ["tool", "adversarial"])
@pytest.mark.parametrize("variant", t_block.VARIANTS)
def test_run_block_model_equals_plain_bitwise(variant, case):
    """The block routed through the pre-test against the plain block: key
    and lane bit for bit, on 12 blocks of 8 subgroups (one with cid -1) of
    the tool's normal tables, or of tables whose dets and quotients sit on
    the pre-test's special values and the clauses' edges."""
    G, SPB, n_blocks = 32, 8, 12
    if case == "tool":
        tbl, feats, gen = _tool_case(G, SPB, n_blocks, seed=2)
    else:
        tbl, feats = (torch.as_tensor(x) for x in block_probe_case(
            K=12, n_sub=96, G=G))
        gen = torch.Generator().manual_seed(3)
    subs, cids = t_block.block_ids(n_blocks, SPB, 96, feats.shape[0], gen)
    cids[4] = -1
    tblc = tbl[subs.long()].reshape(n_blocks, G * SPB, 16).contiguous()
    args = (variant, G, SPB, subs, cids, tbl, feats, tblc)
    want = t_block.run_block_plain(*args)
    (key, lane), refused = t_block.run_block_model(*args)
    assert torch.equal(key, want[0]) and torch.equal(lane, want[1])
    hits = want[0] != INT32_MAX
    if variant == "mm_only":
        assert refused == 0
    else:
        assert 0 < refused < n_blocks * G * SPB * t_block.C
        assert bool(hits.any()) and not bool(hits.all())


def test_model_divides_a_small_share_of_the_tool_pairs():
    """On the tool's normal tables the pre-test lets through under a fifth
    of full's (row, lane) pairs: the kernel's divisions are compacted, so
    their cost follows that share, not the pair count."""
    tbl, feats, gen = _tool_case(32, 8, 8, seed=5)
    subs, cids = t_block.block_ids(8, 8, 96, feats.shape[0], gen)
    _, refused = t_block.run_block_model("full", 32, 8, subs, cids, tbl,
                                         feats)
    share = refused / (8 * 32 * 8 * t_block.C)
    assert 0.8 < share < 0.99, share


# P1: tools/gather_probe.py.

# The distinct orders of P1's kernels: loop adds in index order in both
# tiers; take has one order a tier.
GATHER_ORDERS = [("loop", 4), ("take", 4), ("take", 0)]


@pytest.mark.parametrize("case", list(GATHER_CASES))
@pytest.mark.parametrize("variant,tier", GATHER_ORDERS)
def test_gather_model_within_tolerance_of_plain(variant, tier, case):
    """The kernel-order sums of ``loop`` and ``take`` in each order
    against ``run_gather_plain`` (another order of the same float32
    additions): within ``gather_probe.tolerance``, 2^-14 of the fetched
    magnitudes, on the tool's data and on the edge shapes and magnitudes
    the card tests give the kernels; and finite."""
    idx, tbl = (torch.as_tensor(x) for x in gather_case(case))
    got = t_gather.run_gather_model(idx, tbl, variant, tier)
    want = t_gather.run_gather_plain(idx, tbl, variant)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs()
                 <= t_gather.tolerance(idx, tbl, variant)).all())


def test_gather_model_take_tiers_differ_in_order():
    """The L2 tier's take (8 warp sums) and the shared-memory tier's (32
    lane sums, then a tree) round differently, and loop, in index order
    in both tiers, differs from both: the card tests' bit-for-bit checks
    tell the tiers apart."""
    idx, tbl = (torch.as_tensor(x) for x in gather_case("tool"))
    take = {t: t_gather.run_gather_model(idx, tbl, "take", t) for t in (4, 0)}
    loop = {t: t_gather.run_gather_model(idx, tbl, "loop", t) for t in (4, 0)}
    assert torch.equal(loop[4], loop[0])
    assert not torch.equal(take[4], take[0])
    assert not torch.equal(loop[4], take[4])
    assert not torch.equal(loop[0], take[0])


def test_gather_model_refuses_onehot_and_unknown_tiers():
    idx, tbl = (torch.as_tensor(x) for x in gather_case("tool"))
    with pytest.raises(ValueError, match="onehot"):
        t_gather.run_gather_model(idx, tbl, "onehot", 4)
    for tier in (1, 2, 3):
        with pytest.raises(ValueError, match="tier"):
            t_gather.run_gather_model(idx, tbl, "take", tier)


@pytest.mark.parametrize("end", [0, 1])
def test_gather_tier_at_each_end_of_its_rows(end):
    """``gather_tier`` takes the shared-memory tier (4 columns a slice) at
    each end of ``SLICE_ROWS`` and the L2 tier (0) one row past it."""
    rows = t_gather.SLICE_ROWS[end]
    past = rows + (1 if end else -1)
    assert t_gather.gather_tier(rows) == 4
    assert t_gather.gather_tier(past) == 0


def test_gather_tier_of_the_tool_shapes():
    """The tool's default table (NN 8,192) takes 4-column slices; 1,024
    rows, where the slices were measured slower, and 65,536 rows, whose
    slice does not fit, take the L2 tier."""
    assert t_gather.gather_tier(8192) == 4
    assert t_gather.gather_tier(1024) == 0
    assert t_gather.gather_tier(65_536) == 0
