"""Parity of the card probes' plain versions (``raycore_tpu_torch/tools/``)
with the repository's TPU tools (``tools/*.py``), on the CPU.

Each tool is imported by path and left untouched. P2 and P3 run through
the tool's own ``run`` / ``make_fn`` with the module's ``pl`` swapped for
a proxy whose ``pallas_call`` runs in interpret mode; P1 and P4, whose
entry functions return only timings, run the same ``pallas_call`` the
tool builds around its own kernel functions, in interpret mode. Inputs are NumPy arrays made from a
seed; the port's wrappers get CPU tensors, so they take their plain
versions and launch nothing.
"""
import functools
import importlib.util
import os
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raycore_tpu_torch.tools import epilogue_experiments as t_epi
from raycore_tpu_torch.tools import gather_probe as t_gather
from raycore_tpu_torch.tools import probe_block_overhead as t_block
from raycore_tpu_torch.tools import probe_matmul_shapes as t_mm
from raycore_tpu_torch.core.triangle import fma as fma_rn
from torch_parity import CPU

REPO = Path(__file__).resolve().parent.parent
FEAT, C = 16, 128


class _Interpret:
    """The ``pl`` module with ``pallas_call`` in interpret mode."""
    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture
def tool(monkeypatch):
    """Import ``tools/<name>.py`` by path, afresh; whatever it changes in
    ``os.environ`` (its ``setdefault`` of the compile cache) and
    ``sys.path`` is undone after the test. With ``interpret`` its ``pl``
    is the interpret-mode proxy."""
    def load(name, interpret=False):
        key = "JAX_COMPILATION_CACHE_DIR"
        if key in os.environ:
            monkeypatch.setenv(key, os.environ[key])
        else:
            monkeypatch.delenv(key, raising=False)
        monkeypatch.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            f"_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if interpret:
            monkeypatch.setattr(mod, "pl", _Interpret())
        return mod
    return load


def _t(x):
    return torch.as_tensor(np.asarray(x))


# P3: tools/probe_matmul_shapes.py.

PRECISION = {"default": jax.lax.Precision.DEFAULT,
             "high": jax.lax.Precision.HIGH,
             "highest": jax.lax.Precision.HIGHEST}


@pytest.mark.parametrize("prec,dtype", [("highest", "float32"),
                                        ("default", "float32"),
                                        ("high", "float32"),
                                        ("default", "bfloat16")])
@pytest.mark.parametrize("K", [16, 128])
def test_matmul_probe_matches_tool(tool, K, prec, dtype):
    """Row sums of (64, K) @ (K, 128) over 2 steps. The tool on the CPU
    computes every tier in float32 (bf16 inputs: exact products), within
    (K + N) * 2^-24 of the exact product, times the row's sum of product
    magnitudes S (the worst case of float32 summation in any order). The
    plain version models the card's tier, so it sits its own distance from
    the exact product (the TF32 rounding, for tf32) further away."""
    mod = tool("probe_matmul_shapes", interpret=True)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, K)).astype(np.float32)
    b = rng.normal(size=(K, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(mod.make_fn(64, K, 128, PRECISION[prec], jdt, 2)(
        jnp.asarray(a), jnp.asarray(b)))
    ta, tb = _t(a).to(tdt), _t(b).to(tdt)
    t_mm.run_matmul.launches = 0
    got = t_mm.run_matmul(ta, tb, 2, prec)
    assert t_mm.run_matmul.launches == 0
    assert got.shape == (64, 1) and got.dtype == torch.float32
    assert torch.equal(got, t_mm.run_matmul(ta, tb, 7, prec))
    exact = (ta.double() @ tb.double()).sum(1, keepdim=True)
    S = (ta.double().abs() @ tb.double().abs()).sum(1, keepdim=True)
    tol = ((got.double() - exact).abs() + (K + 128) * 2.0 ** -24 * S).numpy()
    assert (np.abs(got.double().numpy() - ref) <= tol).all()


def test_matmul_tiers_and_tolerances():
    """The tool's precisions map to the four kernel tiers. The FMA tier is
    checked bit for bit, the tensor-core tiers within ACC_REL times the
    row's sum of product magnitudes, and that limit tells neighbouring
    tiers apart at the shapes the card checks use: one TF32 pass lies more
    than 4 limits from 3xTF32 on some row, and the unrounded product more
    than 4 from TF32."""
    assert [t_mm.variant_of(p, torch.float32)
            for p in ("highest", "high", "default")] == ["fma", "3xtf32",
                                                          "tf32"]
    assert t_mm.variant_of("highest", torch.bfloat16) == "bf16"
    with pytest.raises(TypeError):
        t_mm.variant_of("highest", torch.float64)
    with pytest.raises(ValueError):
        t_mm.variant_of("fastest", torch.float32)
    a, b = t_mm.operands(128, 16, 64, torch.float32, CPU)
    S = (a.double().abs() @ b.double().abs()).sum(1, keepdim=True)
    assert not t_mm.tolerance(a, b, "fma").any()
    for v in ("bf16", "3xtf32", "tf32"):
        assert torch.equal(t_mm.tolerance(a, b, v),
                           (t_mm.ACC_REL * S).float())
    for M, K, N in ((128, 16, 64), (64, 128, 128), (256, 16, 128),
                    (128, 128, 192)):
        a, b = t_mm.operands(M, K, N, torch.float32, CPU)
        assert t_mm.tier_gap(a, b, "3xtf32") > 4
        assert t_mm.tier_gap(a, b, "tf32") > 4


def test_matmul_fma_tier_order():
    """The FMA tier's plain version on (2, 3) @ (3, N), N = 64, 128 and 192
    (one chunk; two; three, so group 0 adds two), against the kernel's
    order written out: each dot a chain of single-rounding fused
    multiply-adds; per 64-column chunk, thread t of 8 adds its columns
    4t..4t+3 and 32+4t..32+4t+3 in turn from 0, and the 8 partials go
    pairwise, ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)); group 0
    adds chunks 0, 2, ... and group 1 chunks 1, 3, ... in turn from 0; the
    row sum is group 0 + group 1, all in float32."""
    for N in (64, 128, 192):
        _check_fma_order(N)


def _check_fma_order(N):
    a, b = t_mm.operands(2, 3, N, torch.float32, CPU)
    got = t_mm.run_matmul_plain(a, b, 1, "highest")
    zero = torch.zeros((), dtype=torch.float32)
    for r in range(2):
        dots = []
        for n in range(N):
            acc = zero
            for k in range(3):
                acc = fma_rn(a[r, k], b[k, n], acc)
            dots.append(acc)
        groups = [zero, zero]
        for c in range(N // 64):
            parts = []
            for t in range(8):
                s = zero
                for n in (*range(4 * t, 4 * t + 4),
                          *range(32 + 4 * t, 32 + 4 * t + 4)):
                    s = s + dots[64 * c + n]
                parts.append(s)
            p = parts
            chunk = ((p[0] + p[1]) + (p[2] + p[3])) \
                + ((p[4] + p[5]) + (p[6] + p[7]))
            groups[c % 2] = groups[c % 2] + chunk
        assert got[r, 0].view(torch.int32) == (groups[0] + groups[1]) \
            .view(torch.int32)


def test_fma_rn_rounds_once():
    """``core.triangle.fma`` against exact rational arithmetic on 2,000 random
    float32 triples spread over 2^+-60, and on a sum just past a float32
    halfway point, where rounding the float64 sum to nearest first lands
    on the halfway point and then goes to even."""
    rng = np.random.default_rng(1)
    n = 2000
    a, b = ((rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n))
            .astype(np.float32) for _ in range(2))
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-60, 60, n)) \
        .astype(np.float32)
    got = fma_rn(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        near = [np.nextafter(lo, np.float32(-np.inf)), lo,
                np.nextafter(lo, np.float32(np.inf))]
        err = [abs(Fraction(float(f)) - exact) for f in near]
        best = [f for f, e in zip(near, err) if e == min(err)]
        if len(best) == 2:            # a tie goes to the even neighbour
            best = [f for f in best if not f.view(np.int32) & 1]
        assert best[0].view(np.int32) == g.view(np.int32)
    x = torch.tensor([1 + 2.0 ** -12])
    y = torch.tensor([(1 - 2.0 ** -12 + 2.0 ** -24) * 2.0 ** -24])
    one = torch.ones(1)
    # x * y = 2^-24 + 2^-60: the exact sum lies just past 1 + 2^-24.
    assert fma_rn(x, y, one).item() == 1 + 2.0 ** -23
    assert (x.double() * y.double() + 1).float().item() == 1.0


# P1: tools/tpu_gather_probe.py.

def _gather_tool(mod, name, idx, tbl, steps):
    """The tool's ``run_pallas`` call for kernel ``name``, in interpret
    mode (tpu_gather_probe.py:63-95; the loop kernel is rebuilt inline
    there, :74-79)."""
    R, NN = mod.R, tbl.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(steps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, 128), lambda b, idx: (b, 0)))

    def loop(idx_ref, tbl_ref, out_ref):
        b = pl.program_id(0)

        def body(i, acc):
            return acc + tbl_ref[idx_ref[b * R + i], :]
        out_ref[0, :] = jax.lax.fori_loop(0, R, body,
                                          jnp.zeros((128,), jnp.float32))
    kernel = {"loop": loop,
              "onehot": functools.partial(mod._onehot_kernel, NN=NN),
              "take": mod._take_kernel}[name]
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=grid_spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((steps, 128), jnp.float32))(
            jnp.asarray(idx), jnp.asarray(tbl)))


@pytest.mark.parametrize("variant", ["loop", "onehot", "take"])
def test_gather_probe_matches_tool(tool, variant):
    """Per-step sums of 512 rows of a (64, 128) table over 4 steps. The two
    add the same values in other orders: within 2^-14 of the sum of the
    fetched magnitudes (``gather_probe.tolerance``); ``onehot`` rounds the
    table to bf16 in both."""
    mod = tool("tpu_gather_probe")
    rng = np.random.default_rng(0)
    tbl = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, 4 * 512).astype(np.int32)
    ref = _gather_tool(mod, variant, idx, tbl, 4)
    t_gather.run_gather.launches = 0
    got = t_gather.run_gather(_t(idx), _t(tbl), variant)
    assert t_gather.run_gather.launches == 0 and got.shape == (4, 128)
    tol = t_gather.tolerance(_t(idx), _t(tbl), variant).numpy()
    assert (np.abs(got.numpy() - ref) <= tol).all()
    if variant != "onehot":
        lib = t_gather.gather_library(_t(idx), _t(tbl))
        assert (np.abs(lib.numpy() - ref) <= tol).all()


@pytest.mark.parametrize("case", ["one_block_a_step", "one_block_in_all"])
def test_gather_onehot_block_patterns_match_tool(tool, case):
    """``onehot`` on the index patterns the card test gives its kernel, a
    (64, 128) table over 4 steps against the tool in interpret mode: every
    step's 512 indices in one aligned block of 16 rows, block s for step s;
    or every index in the last 16 rows, the other rows never fetched.
    Within ``gather_probe.tolerance``."""
    mod = tool("tpu_gather_probe")
    rng = np.random.default_rng(4)
    tbl = rng.normal(size=(64, 128)).astype(np.float32)
    block = np.repeat(np.arange(4), 512) if case == "one_block_a_step" \
        else np.full(4 * 512, 3)
    idx = (16 * block + rng.integers(0, 16, 4 * 512)).astype(np.int32)
    ref = _gather_tool(mod, "onehot", idx, tbl, 4)
    got = t_gather.run_gather(_t(idx), _t(tbl), "onehot")
    tol = t_gather.tolerance(_t(idx), _t(tbl), "onehot").numpy()
    assert (np.abs(got.numpy() - ref) <= tol).all()


def test_gather_loop_model_equals_tool_bitwise(tool):
    """``run_gather_model``'s ``loop`` in both tiers (one order) against
    the tool's loop kernel in interpret mode, on a (64, 128) table over 4
    steps: both add a step's rows in index order from zero, so bit for
    bit."""
    mod = tool("tpu_gather_probe")
    rng = np.random.default_rng(8)
    tbl = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, 4 * 512).astype(np.int32)
    ref = _gather_tool(mod, "loop", idx, tbl, 4)
    for tier in (4, 0):
        got = t_gather.run_gather_model(_t(idx), _t(tbl), "loop", tier)
        assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("tier", [4, 0])
def test_gather_take_model_matches_tool(tool, tier):
    """``run_gather_model``'s ``take`` in both tiers against the tool's
    take kernel in interpret mode (``jnp.take`` and a sum, its own order):
    within ``gather_probe.tolerance``."""
    mod = tool("tpu_gather_probe")
    rng = np.random.default_rng(9)
    tbl = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, 4 * 512).astype(np.int32)
    ref = _gather_tool(mod, "take", idx, tbl, 4)
    got = t_gather.run_gather_model(_t(idx), _t(tbl), "take", tier).numpy()
    tol = t_gather.tolerance(_t(idx), _t(tbl), "take").numpy()
    assert (np.abs(got - ref) <= tol).all()


# P2: tools/epilogue_experiments.py.

def _epilogue_inputs(TILE, seed_key, n_tiles=4):
    rng = np.random.default_rng(0)
    R = n_tiles * TILE
    phi = rng.standard_normal((R, FEAT), dtype=np.float32)
    feats = rng.standard_normal((n_tiles, FEAT, 4 * C), dtype=np.float32)
    tmin = np.zeros((R, 1), np.float32)
    key0 = (np.full((R, 1), t_epi.SEED_KEY, np.int32) if seed_key == "tool"
            else t_epi.finite_key0(R, device=CPU).numpy())
    return phi, feats, tmin, key0


def _carried_t(keys, variant):
    """The float a key carries: t (bits & ~127) where the variant packs a
    lane, else the key's own bits."""
    return (keys & ~127 if variant in t_epi.ACCEPTING else keys) \
        .view(np.float32)


@pytest.mark.parametrize("variant", t_epi.VARIANTS)
@pytest.mark.parametrize("seed_key", ["tool", "finite"])
@pytest.mark.parametrize("TILE", [16, 64])
def test_epilogue_probe_matches_tool(tool, TILE, seed_key, variant):
    """4 tiles of TILE rows, 8 blocks, under the tool's key0 seed (whose t
    is a NaN, so nothing is accepted) and under a seed that decodes to t =
    10. Tolerances, by variant:
    - matmul_only, full: bit for bit. The tool's CPU dot evaluates the
      16-deep dot as the same ascending fused multiply-add chain.
    - vpu_full: at least 95% of rows bit for bit, every carried t within
      2^-12 relative: XLA's CPU code contracts the VPU sum's products into
      fused multiply-adds where the plain version rounds each product.
    - vpu_only, recip_only: the min over lanes of raw float bits; that
      contraction (and XLA's reciprocal) moves the winning value by at most
      2^-7 relative (seen: 2.4e-3 at these seeds; the winner is the
      negative value nearest zero, where cancellation is largest).
    - no_divide_signtrick: the same accepted rows (the acceptance has no
      reciprocal), t within 2^-7 relative: interpret mode takes the
      approximate reciprocal in bf16 (jax/_src/pallas/primitives.py:783,
      2^-8 relative), the plain version exactly.
    - approx_recip: t within 2^-7 relative on all but one row in 64 (seen:
      1 of 128), where the bf16 reciprocal moves an acceptance compare
      past its threshold and another lane wins."""
    mod = tool("epilogue_experiments", interpret=True)
    phi, feats, tmin, key0 = _epilogue_inputs(TILE, seed_key)
    ref = np.asarray(mod.run(
        jnp.asarray(phi), jnp.asarray(feats), jnp.asarray(tmin),
        jnp.asarray(key0), TILE=TILE, n_blocks=8, variant=variant,
        prec=jax.lax.Precision.HIGHEST))
    t_epi.run_epilogue.launches = 0
    got = t_epi.run_epilogue(_t(phi), _t(feats), _t(tmin), _t(key0),
                             TILE=TILE, n_blocks=8, variant=variant).numpy()
    assert t_epi.run_epilogue.launches == 0 and got.shape == (4 * TILE, 1)
    tg, tr = _carried_t(got, variant), _carried_t(ref, variant)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(got == ref, 0.0, np.abs(tg - tr) / np.abs(tr))
    if variant in ("matmul_only", "full"):
        assert np.array_equal(got, ref)
    elif variant == "vpu_full":
        assert (got == ref).mean() >= 0.95 and (rel <= 2.0 ** -12).all()
    elif variant in ("vpu_only", "recip_only"):
        assert (rel <= 2.0 ** -7).all()
    elif variant == "no_divide_signtrick":
        assert np.array_equal(got != key0, ref != key0)
        assert (rel[got != key0] <= 2.0 ** -7).all()
    else:
        assert (rel > 2.0 ** -7).sum() <= max(1, got.size // 64)
    if variant in t_epi.ACCEPTING:
        accepted = got != key0
        if seed_key == "tool":
            # The tool's seed: every row keeps key0 (its t is a NaN).
            assert not accepted.any() and (key0 == 0x7FFFFF80).all()
        else:
            assert accepted.mean() > 0.5


def test_epilogue_probe_same_tile(tool):
    """same_tile sends every block to tile 0: its rows match the tool bit
    for bit (``full``), and the plain version leaves the other tiles' rows
    0 (the tool leaves them unwritten)."""
    mod = tool("epilogue_experiments", interpret=True)
    phi, feats, tmin, key0 = _epilogue_inputs(32, "finite")
    ref = np.asarray(mod.run(
        jnp.asarray(phi), jnp.asarray(feats), jnp.asarray(tmin),
        jnp.asarray(key0), TILE=32, n_blocks=3, variant="full",
        prec=jax.lax.Precision.HIGHEST, same_tile=True))
    got = t_epi.run_epilogue(_t(phi), _t(feats), _t(tmin), _t(key0),
                             TILE=32, n_blocks=3, variant="full",
                             same_tile=True).numpy()
    assert np.array_equal(got[:32], ref[:32])
    assert (got[32:] == 0).all() and (got[:32] != key0[:32]).any()


# P4: tools/probe_block_overhead.py.

def _block_tool(mod, variant, G, SPB, n_blocks, tbl, feats, subs, cids,
                tbl_contig):
    """The tool's ``run_variant`` call (probe_block_overhead.py:110-139),
    in interpret mode, returning (key, lane)."""
    kernel, ROWS = mod.make_kernel(variant, G, SPB)

    def tbl_spec(s):
        return pl.BlockSpec((1, G, FEAT),
                            lambda b, subs, cids, s=s: (subs[b * SPB + s],
                                                        0, 0))
    if variant == "contig_tbl":
        in_specs = [pl.BlockSpec((1, ROWS, FEAT),
                                 lambda b, subs, cids: (b, 0, 0))]
        ins = (tbl_contig,)
    else:
        in_specs = [tbl_spec(s) for s in range(SPB)]
        ins = (tbl,) * SPB
    in_specs.append(pl.BlockSpec(
        (1, FEAT, 4 * C), lambda b, subs, cids: (jnp.maximum(cids[b], 0),
                                                 0, 0)))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(n_blocks,), in_specs=in_specs,
        out_specs=[pl.BlockSpec((ROWS, 1), lambda b, subs, cids: (b, 0))] * 2)
    k, p = pl.pallas_call(
        kernel, grid_spec=grid_spec, interpret=True,
        out_shape=[jax.ShapeDtypeStruct((n_blocks * ROWS, 1), jnp.int32)] * 2,
    )(jnp.asarray(subs), jnp.asarray(cids), *map(jnp.asarray, ins),
      jnp.asarray(feats))
    return np.asarray(k), np.asarray(p)


@pytest.mark.parametrize("SPB", [8, 16])
@pytest.mark.parametrize("variant", t_block.VARIANTS)
def test_block_probe_matches_tool(tool, variant, SPB):
    """2 blocks of SPB subgroups of 32 rows from a 64-subgroup table, 64
    clusters, the last block's cid -1 (clamped to 0 as the tool does): key
    and lane bit for bit. The tool's CPU dot is the same ascending fused
    multiply-add chain, and its zeroed columns add exact zeros."""
    mod = tool("probe_block_overhead")
    rng = np.random.default_rng(0)
    G, n_blocks = 32, 2
    tbl = rng.normal(size=(65, G, FEAT)).astype(np.float32)
    feats = rng.normal(size=(64, FEAT, 4 * C)).astype(np.float32)
    subs = rng.integers(0, 64, n_blocks * SPB, dtype=np.int32)
    cids = np.array([5, -1], np.int32)
    tblc = rng.normal(size=(n_blocks, G * SPB, FEAT)).astype(np.float32)
    rk, rl = _block_tool(mod, variant, G, SPB, n_blocks, tbl, feats, subs,
                         cids, tblc)
    t_block.run_block.launches = 0
    gk, gl = t_block.run_block(variant, G, SPB, _t(subs), _t(cids), _t(tbl),
                               _t(feats), _t(tblc))
    assert t_block.run_block.launches == 0
    assert np.array_equal(gk.numpy(), rk) and np.array_equal(gl.numpy(), rl)
    hits = rk != 0x7FFFFFFF
    if variant == "mm_only":
        assert hits.all() and (rl == 0).all()
    else:
        assert 0 < hits.sum() < hits.size
        assert (rl[~hits] == 0).all()
