"""The generators: the same seed gives the same inputs, another seed
others; primary rays keep Morton pixel order; shadow rays start on the
surface and reach their light; the instanced motion is as stated."""
import numpy as np
import pytest
import torch
from conftest import REPO

from cardbench.core.grids import jittered_grid, morton_order, seed_rng
from cardbench.core.specs import Specs

SPECS = Specs([REPO])
CPU = torch.device("cpu")
HF = dict(n=24, extent=2.0, amplitude=0.35, seed=0)
BIG = 3000000019


def heightfield(seed=0):
    return SPECS.module("scenes", "heightfield").generate(dict(HF, seed=seed))


def primary(seed, side=16, batches=2):
    return SPECS.module("traffic", "morton_grid").generate(
        dict(side=side, half=0.95, z=3.0, batches=batches), seed,
        heightfield(), CPU)


def shadow(seed, side=16):
    return SPECS.module("traffic", "surface_shadow").generate(
        dict(side=side, half=0.95, batches=2, lift=1e-3,
             lights=[[2.5, -2.5, 4.0], [-2.0, 2.0, 3.5]]), seed,
        heightfield(), CPU)


@pytest.mark.parametrize("make", [primary, shadow], ids=["primary", "shadow"])
def test_same_seed_same_rays_other_seed_other_rays(make):
    a, b, c = make(BIG), make(BIG), make(BIG + 1)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["o"], c[0]["o"])
    assert not torch.equal(a[0]["o"], a[1]["o"])


def test_the_heightfield_is_the_port_s_at_the_configuration_s_seed():
    import raycore_tpu_torch as rt
    s = heightfield()
    assert s["faces"].shape == (2 * 24 * 24, 3)
    mesh = rt.displaced_grid_mesh(n=24, device="cpu")
    assert np.array_equal(s["verts"][s["faces"]], mesh.vertices.numpy())
    assert not np.array_equal(heightfield(1)["verts"], s["verts"])


def test_morton_order_of_a_small_grid():
    assert morton_order(2).tolist() == [0, 1, 2, 3]
    assert morton_order(4)[:8].tolist() == [0, 1, 4, 5, 2, 3, 6, 7]


def test_primary_rays_keep_morton_pixel_order_inside_their_pixels():
    side, half = 16, 0.95
    xy = jittered_grid(side, half, seed_rng(BIG, 3, 0))
    xs = np.linspace(-half, half, side)
    step = xs[1] - xs[0]
    pix = np.rint((xy - xs[0]) / step).astype(int)
    assert np.abs(xy - xs[pix]).max() <= step / 2
    assert (pix[:, 0] * side + pix[:, 1]).tolist() == \
        morton_order(side).tolist()
    b = primary(BIG, side)[0]
    assert torch.allclose(b["o"][:, :2].double(), torch.as_tensor(xy),
                          atol=1e-6)
    assert bool((b["d"] == torch.tensor([0.0, 0.0, -1.0])).all())


def test_shadow_rays_start_on_the_surface_and_reach_a_light():
    seed = BIG
    scene = heightfield()
    lights = torch.tensor([[2.5, -2.5, 4.0], [-2.0, 2.0, 3.5]],
                          dtype=torch.float64)
    for k, b in enumerate(shadow(seed)):
        o, d = b["o"].double(), b["d"].double()
        end = o + b["t_max"].double()[:, None] * d
        gap = (end[:, None] - lights[None]).norm(dim=2).min(1).values
        assert float(gap.max()) < 1e-5
        # o is lift above the face under its grid position, and o minus
        # lift along that face's normal is that grid position.
        xy = jittered_grid(16, 0.95, seed_rng(seed, 4, k))
        face = scene["face_under"](xy)
        tri = torch.as_tensor(scene["verts"][scene["faces"][face]],
                              dtype=torch.float64)
        n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = n / n.norm(dim=1, keepdim=True)
        dist = ((o - tri[:, 0]) * n).sum(1)
        assert float((dist.abs() - 1e-3).abs().max()) < 1e-6
        p = o - dist[:, None] * n
        assert float((p[:, :2] - torch.as_tensor(xy)).abs().max()) < 1e-6
        # Both lights are drawn.
        near = (end[:, None] - lights[None]).norm(dim=2).argmin(1)
        assert 0 < int(near.sum()) < near.numel()


def test_instances_move_as_the_source_moves_them():
    scene = SPECS.module("scenes", "instanced").generate(
        dict(count=128, centers=[[-5, -5, -5], [5, 5, 5]], seed=0,
             bases=[dict(kind="sphere", radius=0.3, n_theta=8, n_phi=16)]))
    # examples/dynamic_refit.py: default_rng(0).uniform(-5, 5, (128, 3)).
    src = np.random.default_rng(0).uniform(-5, 5, (128, 3)).astype(np.float32)
    assert np.array_equal(scene["centers"], src)
    assert scene["bases"][0][1].shape == (224, 3)
    make = lambda seed: SPECS.module("traffic", "translated_instances") \
        .generate(dict(side=8, half=6.0, z=6.0, sets=6, step=[0.1, 0, 0]),
                  seed, scene, CPU)
    tr = make(BIG)
    m = tr["transforms"]
    assert m.shape == (6, 128, 3, 4) and m.dtype == np.float32
    assert np.array_equal(m[:, :, :, :3], np.broadcast_to(np.eye(3),
                                                          m[..., :3].shape))
    for k in range(6):
        want = src + np.float32(0.1) * (k + 1) * np.array([1, 0, 0])
        assert np.allclose(m[k, :, :, 3], want, atol=1e-6)
    assert np.array_equal(tr["initial"][:, :, 3], src)
    o = tr["rays"]["o"]
    assert o.shape == (64, 3) and bool((o[:, 2] == 6.0).all())
    assert float(o[:, :2].abs().max()) <= 6.0 + 12 / 7 / 2
    assert torch.equal(o, make(BIG)["rays"]["o"])
    assert not torch.equal(o, make(BIG + 1)["rays"]["o"])
