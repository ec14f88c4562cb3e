"""Example scenes for the renderers, tests and benchmarks (counterpart of
``raycore_tpu/render/scenes.py``): a room with props and per-mesh
material metadata, and an instanced particle field. Both are built with
the port's ``TLAS`` manager on ``device``, the CUDA card by default; the
room's ``StaticTLAS`` equals the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import default_device
from ..core.triangle import Triangle
from ..scene.mesh import box_mesh, plane_mesh, sphere_mesh
from ..scene.tlas import TLAS
from .wavefront import Camera, Materials, PointLights


def _with_material(tris: Triangle, mat_idx: int) -> Triangle:
    return dataclasses.replace(tris, metadata=torch.full(
        tris.batch_shape, mat_idx, dtype=torch.int64, device=tris.device))


def example_scene(device=None):
    """Room + props, 6 meshes with per-mesh material metadata.

    Returns (static_tlas, materials, lights, camera). Material indices:
    0 floor, 1 back wall, 2 side wall, 3 matte sphere, 4 metallic sphere,
    5 box.
    """
    dev = default_device(device)
    mgr = TLAS(device=dev)
    for mesh, mat in (
            (plane_mesh(center=(0, 0, 0), u=(4, 0, 0), v=(0, 4, 0),
                        device=dev), 0),
            (plane_mesh(center=(0, 4, 2), u=(4, 0, 0), v=(0, 0, 2),
                        device=dev), 1),
            (plane_mesh(center=(-4, 0, 2), u=(0, 4, 0), v=(0, 0, 2),
                        device=dev), 2),
            (sphere_mesh(center=(0.0, 1.0, 1.0), radius=1.0, n_theta=24,
                         n_phi=48, device=dev), 3),
            (sphere_mesh(center=(2.0, -0.5, 0.7), radius=0.7, n_theta=24,
                         n_phi=48, device=dev), 4),
            (box_mesh(p_min=(-2.6, -0.4, 0.0), p_max=(-1.4, 0.8, 1.2),
                      device=dev), 5)):
        mgr.push(_with_material(mesh, mat))
    scene = mgr.sync()

    materials = Materials.create(
        base_color=np.array([
            [0.75, 0.75, 0.75],   # floor
            [0.65, 0.25, 0.22],   # back wall
            [0.25, 0.45, 0.65],   # side wall
            [0.85, 0.65, 0.25],   # matte sphere
            [0.95, 0.95, 0.95],   # metal sphere
            [0.35, 0.65, 0.35],   # box
        ], np.float32),
        metallic=np.array([0.0, 0.0, 0.0, 0.0, 0.9, 0.0], np.float32),
        roughness=np.array([0.8, 0.9, 0.9, 0.6, 0.1, 0.7], np.float32),
        device=dev)
    lights = PointLights.create(
        position=[[3.0, -3.0, 5.0], [-3.0, -1.0, 4.0]],
        intensity=[[30.0, 30.0, 28.0], [8.0, 9.0, 12.0]], device=dev)
    camera = Camera.create(position=(1.5, -6.0, 2.5), target=(0.0, 0.5, 1.0),
                           up=(0, 0, 1), fov_deg=50.0, device=dev)
    return scene, materials, lights, camera


def particle_scene(n_particles=1024, seed=0, device=None):
    """Instanced particles: one low-poly sphere BLAS, one multi-transform
    handle with n instances at positions uniform in [-4, 4]^3 (scale
    0.08). Returns (tlas_manager, handle, positions)."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (n_particles, 3)).astype(np.float32)
    transforms = np.tile(np.eye(3, 4, dtype=np.float32), (n_particles, 1, 1))
    transforms[:, :, :3] *= 0.08
    transforms[:, :, 3] = pos
    mgr = TLAS(device=dev)
    h = mgr.push(sphere_mesh(radius=1.0, n_theta=6, n_phi=8, device=dev),
                 transforms=list(transforms))
    return mgr, h, pos
