"""Query entry points (counterpart of ``raycore_tpu/accel/dispatch.py``):
``scene_closest_hit`` and ``scene_any_hit`` route by scene form, as the
JAX package does.

- ``StaticTLAS``: the two-level traversal (``accel/traversal.py``), with
  ``tile_size`` and ``**trav_kw`` (``stack_size``, ``max_iters``,
  ``substeps``).
- ``DenseInstancedScene``: the instanced engine
  (``ops/instanced.py:closest_hit_instanced`` / ``any_hit_instanced``)
  at any batch size; ``**trav_kw`` raises ``TypeError``.
- ``DenseScene``: by batch size, as the JAX package does once its
  big-batch engines are warm. ``closest_hit``: a batch of at least
  ``REGROUP_MIN_RAYS`` rays goes to the regrouped engine (tile 2048) on a
  scene with sub_chunks == 1 and to the packed sub-cluster engine
  (``closest_hit_packed``, tile 2048) on a scene with sub_chunks >= 2;
  every other batch goes to the tile worklist (tile 512 at the default
  ``tile_size``). ``any_hit``: a batch of at least that many rays on a
  sub_chunks == 1 scene goes to the regrouped occlusion, every other
  batch to the worklist occlusion. The regrouped closest hit runs at
  ``BIG_BATCH_PASSES``.

The warmth and opt-in gates of the JAX rule guard against remote
compiles and are not ported: ``has_warm_capacity`` and ``prewarm`` keep
the JAX package's names for its callers. The results contract does not
depend on the engine.
"""
from __future__ import annotations

from ..utils.config import span
from . import traversal as _trav
from .dense import DenseScene
from .types import StaticTLAS

# Queries below this size do not amortize the regrouped engines' stage 1;
# they stay on the tile worklist.
REGROUP_MIN_RAYS = 1 << 19
# The regrouped engine's ``passes`` on the big-batch route. The JAX
# package passes "auto" there, which resolves to 4 on both 1M-triangle
# scenes the port is timed on (the heightfield as well as blobby); on the
# H100 passes=4 ran slower on the heightfield and no faster beyond the
# runs' spread on blobby, so the route keeps 1 (ROADMAP.md, the dispatch
# decision).
BIG_BATCH_PASSES = 1


def _big_batch(scene, rays) -> bool:
    """Whether a query on a DenseScene is large enough for the regrouped
    engines."""
    n_rays = 1
    for s in rays.batch_shape:
        n_rays *= s
    return n_rays >= REGROUP_MIN_RAYS


def _worklist_tile(tile_size: int) -> int:
    """The tile worklist's ray tile for a caller's ``tile_size``, as the
    JAX package picks it: 512 at the default."""
    return min(512, max(tile_size, 8))


def scene_closest_hit(scene, rays, *, tile_size: int = 16384,
                      payload: str = "full", deferred: bool = False,
                      **trav_kw):
    """Closest hit over a scene, the package-level ``closest_hit``.

    payload="slim" declares that the caller never reads triangle or
    barycentric: the regrouped engine then skips the payload gather
    (hit/t/prim_idx/instance_idx/metadata stay exact). The packed engine
    and the tile worklist have no slim mode and return the full
    payload. ``tile_size`` sets the tile worklist's ray tile
    (``min(512, max(tile_size, 8))``). ``deferred=True`` returns
    ``(result, None)``: every query here syncs, so the result is valid
    and there is nothing to finalize. ``trav_kw`` (the BVH traversal's
    options) raises ``TypeError`` on a ``DenseScene``, as in the JAX
    package. A ``StaticTLAS`` goes to the traversal and a
    ``DenseInstancedScene`` to the instanced engine (module docstring)."""
    with span("raycore.closest_hit"):
        routed = _other_forms(scene, rays, tile_size, trav_kw,
                              any_hit=False)
        if routed is not None:
            return (routed, None) if deferred else routed
        big = _big_batch(scene, rays)
        if trav_kw:
            raise TypeError(f"dense-engine queries do not accept {trav_kw}")
        if big and scene.sub_chunks == 1:
            from ..ops.regroup import closest_hit_regrouped
            res = closest_hit_regrouped(scene, rays, tile=2048,
                                        passes=BIG_BATCH_PASSES,
                                        payload=payload)
        elif big:
            from ..ops.regroup import closest_hit_packed
            res = closest_hit_packed(scene, rays, tile=2048)
        else:
            from ..ops.dense import closest_hit_dense_pallas_auto
            res = closest_hit_dense_pallas_auto(
                scene, rays, tile=_worklist_tile(tile_size))
        return (res, None) if deferred else res


def scene_any_hit(scene, rays, *, tile_size: int = 16384,
                  deferred: bool = False, **trav_kw):
    """Occlusion over a scene, the package-level ``any_hit``: t_min is
    forced to 0, and only hit, prim_idx and instance_idx are
    contractual. ``tile_size``, ``deferred`` and ``trav_kw`` as in
    ``scene_closest_hit``."""
    with span("raycore.any_hit"):
        routed = _other_forms(scene, rays, tile_size, trav_kw, any_hit=True)
        if routed is not None:
            return (routed, None) if deferred else routed
        big = _big_batch(scene, rays)
        if trav_kw:
            raise TypeError(f"dense-engine queries do not accept {trav_kw}")
        if big and scene.sub_chunks == 1:
            from ..ops.regroup import any_hit_regrouped
            res = any_hit_regrouped(scene, rays, tile=2048)
        else:
            from ..ops.dense import any_hit_dense_pallas_auto
            res = any_hit_dense_pallas_auto(
                scene, rays, tile=_worklist_tile(tile_size))
        return (res, None) if deferred else res


def _other_forms(scene, rays, tile_size: int, trav_kw: dict, any_hit: bool):
    """The query on a StaticTLAS or a DenseInstancedScene, or None for a
    DenseScene."""
    from ..scene.instanced import DenseInstancedScene
    if isinstance(scene, DenseInstancedScene):
        if trav_kw:
            raise TypeError(f"instanced queries do not accept {trav_kw}")
        from ..ops import instanced
        fn = (instanced.any_hit_instanced if any_hit
              else instanced.closest_hit_instanced)
        return fn(scene, rays)
    if isinstance(scene, StaticTLAS):
        fn = _trav.any_hit if any_hit else _trav.closest_hit
        return fn(scene, rays, tile_size=tile_size, **trav_kw)
    if not isinstance(scene, DenseScene):
        raise TypeError(f"no query route for a {type(scene).__name__}")
    return None


def has_warm_capacity(scene, n_rays: int, **kw) -> bool:
    """Whether the regrouped engine is ready for a big query on this
    scene: ``getattr(scene, "sub_chunks", 1) == 1``, the JAX package's
    first test. The port sizes every query from its data and keeps no
    capacity cache, so nothing else is warmed; ``n_rays`` and the JAX
    keywords (tile, subgroup, spb, passes, occlusion, payload) are taken
    and do not change the answer."""
    return getattr(scene, "sub_chunks", 1) == 1


def prewarm(scene, n_rays: int, **kw) -> None:
    """Build the kernel library for a scene on the card, so that the
    first query does not pay for the build; a CPU scene needs nothing.
    Runs no query and returns None: the port has no capacities to size
    and no stage graphs to compile. ``n_rays`` and the JAX keywords
    (engine, tile, subgroup, spb, spb_sub, packs, passes) are taken and
    ignored. A StaticTLAS (the traversal has no kernel) needs nothing."""
    feats = getattr(scene, "tri_feats", None)
    if feats is not None and feats.device.type == "cuda":
        from ..kernels import _build
        _build.library()
