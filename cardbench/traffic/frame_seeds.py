"""Seeds of a renderer's frames: ``sets`` generator seeds drawn from the
run's seed. Frame k of a loop renders with a ``torch.Generator`` seeded
with set k mod ``sets``, so each set's frame can be rendered again
exactly."""
from __future__ import annotations

from cardbench.core.grids import seed_rng

STREAM = 7


def generate(params: dict, seed: int, scene: dict, device) -> list:
    rng = seed_rng(seed, STREAM, 0)
    return [int(x) for x in rng.integers(0, 2**62, params["sets"])]
