"""The regrouped engine's ordered multiwave end to end against the JAX
package, on the CPU: ``closest_hit_regrouped`` at passes 2, 3, 4 and
"auto" on two small blobby scenes (tests/test_pallas_regroup.py:81-138's
ray recipes) and a heightfield, held by ``torch_parity.check_hits``
(equal hit masks, t within rtol 2e-5, a differing prim only as a t tie)
to JAX's default (sort) stage 1, to JAX's ``stage1="compact"``, to
the brute-force oracle and to the port's own passes=1.

Each JAX result is computed once (JAX compiles per ``passes``).
"""
import numpy as np
import pytest

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.accel.brute import closest_hit_brute as j_brute
from raycore_tpu.ops import pallas_regroup as j_pr
from raycore_tpu_torch.ops import regroup as t_pr
from raycore_tpu_torch.scene import mesh as t_mesh
from test_torch_multiwave import incoherent_rays
from torch_parity import CPU, check_hits, jax_rays, ray_arrays, torch_rays

# Scene name -> (meshes of both packages, C, rays).
SCENES = {
    # test_pallas_regroup.py:108-124 (compact vs sort): blobby 64x64, C=64.
    "blobby64": (lambda m, **kw: m.blobby_mesh(64, 64, **kw), 64,
                 lambda: incoherent_rays(R=1536, seed=7, dz=0.3)),
    # test_pallas_regroup.py:81-94's rays on a 48x48 blobby at C=128.
    "blobby48": (lambda m, **kw: m.blobby_mesh(48, 48, **kw), 128,
                 lambda: incoherent_rays(R=1024, seed=3, dz=0.5)),
    # test_pallas_regroup.py:18-36's heightfield and random rays.
    "heightfield": (lambda m, **kw: m.displaced_grid_mesh(
        n=40, extent=2.0, amplitude=0.35, **kw), 128,
        lambda: ray_arrays(R=1024, seed=0)),
}
# (scene, passes) -> the JAX stage-1 variants it is held to.
CASES = {("blobby64", 2): ("sort", "compact"),
         ("blobby64", 4): ("sort", "compact"),
         ("blobby64", "auto"): ("sort",),
         ("blobby48", 3): ("sort", "compact"),
         ("heightfield", 4): ("sort",),
         ("heightfield", "auto"): ("compact",)}


@pytest.fixture(scope="module")
def world():
    """Each scene in both packages, its rays, the oracle's and the port's
    passes=1 results, and a cache of JAX results."""
    out = {}
    for name, (mesh, C, rays) in SCENES.items():
        js = j_dense.build_dense(mesh(rc), cluster_size=C)
        ts = rt.build_dense(mesh(t_mesh, device=CPU), cluster_size=C)
        o, d = rays()
        out[name] = dict(
            js=js, ts=ts, o=o, d=d,
            oracle=j_brute(js.prims, jax_rays(o, d)),
            one=t_pr.closest_hit_regrouped(ts, torch_rays(o, d), passes=1))
    out["jax"] = {}
    return out


def jax_result(world, name, passes, stage1):
    """JAX's closest_hit_regrouped at ``passes`` (resolved) through its
    ``stage1`` variant, computed once."""
    key = (name, passes, stage1)
    if key not in world["jax"]:
        w = world[name]
        world["jax"][key] = j_pr.closest_hit_regrouped(
            w["js"], jax_rays(w["o"], w["d"]), passes=passes, stage1=stage1)
    return world["jax"][key]


@pytest.mark.parametrize("name,passes", list(CASES), ids=[
    f"{n}-{p}" for n, p in CASES])
def test_closest_hit_at_passes_matches_jax_and_oracle(world, name, passes):
    w = world[name]
    got = t_pr.closest_hit_regrouped(w["ts"], torch_rays(w["o"], w["d"]),
                                     passes=passes)
    resolved = passes
    if passes == "auto":
        resolved = t_pr.auto_passes(w["ts"])
        assert resolved == j_pr.auto_passes(w["js"])
        assert resolved == (1 if name == "heightfield" else 4)
    check_hits(w["oracle"], got)
    check_hits(w["one"], got)
    for stage1 in CASES[name, passes]:
        check_hits(jax_result(world, name, resolved, stage1), got)
    assert 0.1 < float(np.asarray(got.hit.float().mean())) <= 1.0
