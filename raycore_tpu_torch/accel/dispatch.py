"""Query entry point (counterpart of ``raycore_tpu/accel/dispatch.py``,
partial: ``scene_closest_hit`` for ``DenseScene``).

Every ``DenseScene`` batch goes to the regrouped engine with tile=2048 and
passes=1; the results contract does not depend on the engine. Small
batches move to the tile worklist once kernel K3 is ported.
"""
from __future__ import annotations

from .brute import HitResult
from .dense import DenseScene


def scene_closest_hit(scene, rays, *, payload: str = "full") -> HitResult:
    """Closest hit over a scene, the package-level ``closest_hit``.

    payload="slim" declares that the caller never reads triangle or
    barycentric; hit/t/prim_idx/instance_idx/metadata stay exact."""
    if not isinstance(scene, DenseScene):
        raise NotImplementedError(
            f"closest_hit on {type(scene).__name__}: only DenseScene is "
            f"ported (the BVH and instanced scenes are ROADMAP.md queue 1 "
            f"items 8 and 9)")
    from ..ops.regroup import closest_hit_regrouped
    return closest_hit_regrouped(scene, rays, tile=2048, passes=1,
                                 payload=payload)
