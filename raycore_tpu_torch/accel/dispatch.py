"""Query entry points (counterpart of ``raycore_tpu/accel/dispatch.py``,
partial: ``scene_closest_hit`` and ``scene_any_hit`` for ``DenseScene``).

Both route on batch size, as the JAX package does once its regrouped
engine is warm: a batch of at least ``REGROUP_MIN_RAYS`` rays on a scene
with sub_chunks == 1 goes to the regrouped engine (tile 2048); every other
batch goes to the tile worklist (tile 512). The warmth and opt-in gates
of the JAX rule guard against remote compiles and are not ported. The
results contract does not depend on the engine.
"""
from __future__ import annotations

from .brute import HitResult
from .dense import DenseScene

# Queries below this size do not amortize the regrouped engine's stage 1;
# they stay on the tile worklist.
REGROUP_MIN_RAYS = 1 << 19


def _regrouped(scene, rays) -> bool:
    """Whether a query goes to the regrouped engine."""
    if not isinstance(scene, DenseScene):
        raise NotImplementedError(
            f"queries on {type(scene).__name__}: only DenseScene is ported "
            f"(the BVH and instanced scenes are ROADMAP.md queue 1 items 8 "
            f"and 9)")
    n_rays = 1
    for s in rays.batch_shape:
        n_rays *= s
    return n_rays >= REGROUP_MIN_RAYS and scene.sub_chunks == 1


def scene_closest_hit(scene, rays, *, payload: str = "full") -> HitResult:
    """Closest hit over a scene, the package-level ``closest_hit``.

    payload="slim" declares that the caller never reads triangle or
    barycentric: the regrouped engine then skips the payload gather
    (hit/t/prim_idx/instance_idx/metadata stay exact). The tile worklist
    has no slim mode and returns the full payload."""
    if _regrouped(scene, rays):
        from ..ops.regroup import closest_hit_regrouped
        return closest_hit_regrouped(scene, rays, tile=2048, passes=1,
                                     payload=payload)
    from ..ops.dense import closest_hit_dense_pallas_auto
    return closest_hit_dense_pallas_auto(scene, rays, tile=512)


def scene_any_hit(scene, rays) -> HitResult:
    """Occlusion over a scene, the package-level ``any_hit``: t_min is
    forced to 0, and only hit, prim_idx and instance_idx are
    contractual."""
    if _regrouped(scene, rays):
        from ..ops.regroup import any_hit_regrouped
        return any_hit_regrouped(scene, rays, tile=2048)
    from ..ops.dense import any_hit_dense_pallas_auto
    return any_hit_dense_pallas_auto(scene, rays, tile=512)
