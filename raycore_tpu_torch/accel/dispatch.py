"""Query entry points (counterpart of ``raycore_tpu/accel/dispatch.py``,
partial: ``scene_closest_hit`` and ``scene_any_hit`` for ``DenseScene``).

Both route on batch size, as the JAX package does once its big-batch
engines are warm. ``closest_hit``: a batch of at least
``REGROUP_MIN_RAYS`` rays goes to the regrouped engine (tile 2048) on a
scene with sub_chunks == 1 and to the packed sub-cluster engine
(``closest_hit_packed``, tile 2048) on a scene with sub_chunks >= 2;
every other batch goes to the tile worklist (tile 512). ``any_hit``: a
batch of at least that many rays on a sub_chunks == 1 scene goes to the
regrouped occlusion, every other batch to the worklist occlusion. The
warmth and opt-in gates of the JAX rule guard against remote compiles
and are not ported. The results contract does not depend on the engine.
"""
from __future__ import annotations

from .brute import HitResult
from .dense import DenseScene

# Queries below this size do not amortize the regrouped engines' stage 1;
# they stay on the tile worklist.
REGROUP_MIN_RAYS = 1 << 19


def _big_batch(scene, rays) -> bool:
    """Whether a query is large enough for the regrouped engines."""
    if not isinstance(scene, DenseScene):
        raise NotImplementedError(
            f"queries on {type(scene).__name__}: only DenseScene is ported "
            f"(the BVH and instanced scenes are ROADMAP.md queue 1 items 8 "
            f"and 9)")
    n_rays = 1
    for s in rays.batch_shape:
        n_rays *= s
    return n_rays >= REGROUP_MIN_RAYS


def scene_closest_hit(scene, rays, *, payload: str = "full") -> HitResult:
    """Closest hit over a scene, the package-level ``closest_hit``.

    payload="slim" declares that the caller never reads triangle or
    barycentric: the regrouped engine then skips the payload gather
    (hit/t/prim_idx/instance_idx/metadata stay exact). The packed engine
    and the tile worklist have no slim mode and return the full
    payload."""
    if _big_batch(scene, rays):
        if scene.sub_chunks == 1:
            from ..ops.regroup import closest_hit_regrouped
            return closest_hit_regrouped(scene, rays, tile=2048, passes=1,
                                         payload=payload)
        from ..ops.regroup import closest_hit_packed
        return closest_hit_packed(scene, rays, tile=2048)
    from ..ops.dense import closest_hit_dense_pallas_auto
    return closest_hit_dense_pallas_auto(scene, rays, tile=512)


def scene_any_hit(scene, rays) -> HitResult:
    """Occlusion over a scene, the package-level ``any_hit``: t_min is
    forced to 0, and only hit, prim_idx and instance_idx are
    contractual."""
    if _big_batch(scene, rays) and scene.sub_chunks == 1:
        from ..ops.regroup import any_hit_regrouped
        return any_hit_regrouped(scene, rays, tile=2048)
    from ..ops.dense import any_hit_dense_pallas_auto
    return any_hit_dense_pallas_auto(scene, rays, tile=512)
