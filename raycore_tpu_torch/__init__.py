"""raycore_tpu_torch — the ray-triangle intersection engine in PyTorch and
CUDA, beside the JAX package ``raycore_tpu``.

It keeps the JAX package's layout and function names. Tensors stay on the
device they are made on; a kernel wrapper launches its CUDA kernel for
CUDA tensors and runs the kernel's plain PyTorch version for CPU tensors.
The ported slice is ``closest_hit`` on a ``DenseScene``.
"""
from .core.ray import Ray
from .core.triangle import Triangle, fast_intersect_triangle, safe_invdir
from .accel.brute import HitResult, closest_hit_brute
from .accel.dense import DenseScene, build_dense
from .accel.dispatch import scene_closest_hit as closest_hit
from .ops.regroup import closest_hit_regrouped
from .scene.mesh import (blobby_mesh, build_triangles, displaced_grid_mesh,
                         uv_sphere)

__all__ = ["Ray", "Triangle", "HitResult", "DenseScene", "build_dense",
           "closest_hit", "closest_hit_regrouped", "closest_hit_brute",
           "fast_intersect_triangle", "safe_invdir", "blobby_mesh",
           "build_triangles", "displaced_grid_mesh", "uv_sphere"]
