"""raycore_tpu_torch — the ray-triangle intersection engine in PyTorch and
CUDA, beside the JAX package ``raycore_tpu``.

It keeps the JAX package's layout and function names. Entry points make
their tensors on the CUDA card unless the caller passes ``device="cpu"``;
tensors then stay on their device, and a kernel wrapper launches its CUDA
kernel for CUDA tensors and runs the kernel's plain PyTorch version for
CPU tensors. The ported slice:

- the core math (rays, boxes, transforms, quaternions, triangles and
  their tests);
- ``closest_hit`` and ``any_hit`` on a ``DenseScene``: for batches of at
  least 2^19 rays the regrouped engine (sub_chunks == 1; ``passes`` >= 2
  or "auto" runs its ordered multiwave) or the packed sub-cluster engine
  (``closest_hit_packed``, sub_chunks >= 2; ``any_hit`` takes the
  worklist there), and the tile worklist (``closest_hit_dense_pallas*``,
  ``any_hit_dense_pallas_auto``) for smaller batches; plus the dense
  brute-force sweep for small meshes (``closest_hit_brute_pallas``);
- the two-level BVH: the LBVH build (``build_blas``), the mutable
  ``TLAS`` manager whose ``sync`` gives a ``StaticTLAS``, and the
  traversal that ``closest_hit``/``any_hit`` run on it;
- the instanced engine: ``bake_instanced`` turns a ``TLAS`` into a
  ``DenseInstancedScene``, ``refresh_instances`` follows its transforms
  each frame, and ``closest_hit``/``any_hit`` sweep it with K1 and K2's
  pairrow mode (``ops/instanced.py``); ``bake_dense`` bakes a ``TLAS``
  into one world-space ``DenseScene``.

``raycore_tpu_torch.tools`` holds the card probes, the counterparts of the
repository's TPU measurement tools (P1-P4): each is a hand-written kernel
with its plain version and the tool's entry point. With them every TPU
kernel of the JAX package has a counterpart here.
"""
from .core.ray import (Ray, RayDifferentials, apply, check_direction,
                       increase_hit, scale_differentials, set_direction)
from .core.bounds import (Bounds2, Bounds3, union, intersect_bounds, overlaps,
                          inside, inside_exclusive, expand, diagonal,
                          surface_area, volume, maximum_extent, corner,
                          corners, lerp, offset, bounding_sphere,
                          intersect_ray, intersect_p, fast_intersect_bbox)
from .core.transforms import (Transformation, Quaternion, translate, scale,
                              rotate, rotate_x, rotate_y, rotate_z, look_at,
                              perspective, has_scale, swaps_handedness, slerp,
                              mat4_to_mat3x4, mat3x4_inverse, mat3x4_identity,
                              transform_point_3x4, transform_direction_3x4)
from .core.triangle import (Triangle, empty_triangle, area, normal,
                            is_degenerate, intersect_triangle,
                            fast_intersect_triangle, safe_invdir,
                            partial_derivatives, normal_derivatives,
                            object_bound, world_bound, bary_interp)
from .accel.brute import HitResult, any_hit_brute, closest_hit_brute
from .accel.types import (BLAS, INVALID_NODE, TOP_LEVEL_SENTINEL, Instances,
                          StaticTLAS)
from .accel.lbvh import build_blas, karras_topology, refit_aabbs
from .accel.dense import DenseScene, build_dense, depth_layers
from .accel.dispatch import has_warm_capacity, prewarm
from .accel.dispatch import scene_any_hit as any_hit
from .accel.dispatch import scene_closest_hit as closest_hit
from .ops.brute import closest_hit_brute_pallas
from .ops.dense import (any_hit_dense_pallas_auto, closest_hit_dense_pallas,
                        closest_hit_dense_pallas_auto,
                        closest_hit_dense_pallas_topk)
from .ops.regroup import (any_hit_regrouped, auto_passes, closest_hit_packed,
                          closest_hit_regrouped)
from .scene.tlas import (INVALID_HANDLE, TLAS, TLASHandle,
                         blas_to_static_tlas, instance_buffer, refit_tlas)
from .scene.bake import bake_dense, flatten_world_triangles
from .scene.instanced import (DenseInstancedScene, bake_instanced,
                              refresh_instances)
from .scene.mesh import (blobby_mesh, box_mesh, build_triangle,
                         build_triangles, displaced_grid_mesh,
                         is_degenerate_face, plane_mesh, sphere_mesh,
                         uv_sphere)

__all__ = [
    "Ray", "RayDifferentials", "apply", "check_direction", "increase_hit",
    "scale_differentials", "set_direction",
    "Bounds2", "Bounds3", "union", "intersect_bounds", "overlaps", "inside",
    "inside_exclusive", "expand", "diagonal", "surface_area", "volume",
    "maximum_extent", "corner", "corners", "lerp", "offset",
    "bounding_sphere", "intersect_ray", "intersect_p", "fast_intersect_bbox",
    "Transformation", "Quaternion", "translate", "scale", "rotate",
    "rotate_x", "rotate_y", "rotate_z", "look_at", "perspective",
    "has_scale", "swaps_handedness", "slerp", "mat4_to_mat3x4",
    "mat3x4_inverse", "mat3x4_identity", "transform_point_3x4",
    "transform_direction_3x4",
    "Triangle", "empty_triangle", "area", "normal", "is_degenerate",
    "intersect_triangle", "fast_intersect_triangle", "safe_invdir",
    "partial_derivatives", "normal_derivatives", "object_bound",
    "world_bound", "bary_interp",
    "HitResult", "closest_hit_brute", "any_hit_brute",
    "BLAS", "Instances", "StaticTLAS", "INVALID_NODE", "TOP_LEVEL_SENTINEL",
    "build_blas", "karras_topology", "refit_aabbs",
    "TLAS", "TLASHandle", "INVALID_HANDLE", "blas_to_static_tlas",
    "instance_buffer", "refit_tlas", "bake_dense", "flatten_world_triangles",
    "DenseInstancedScene", "bake_instanced", "refresh_instances",
    "DenseScene",
    "build_dense", "depth_layers", "closest_hit", "any_hit", "prewarm",
    "has_warm_capacity", "closest_hit_regrouped", "any_hit_regrouped",
    "auto_passes", "closest_hit_packed", "closest_hit_dense_pallas",
    "closest_hit_dense_pallas_auto", "closest_hit_dense_pallas_topk",
    "any_hit_dense_pallas_auto", "closest_hit_brute_pallas",
    "blobby_mesh", "box_mesh", "build_triangle", "build_triangles",
    "displaced_grid_mesh", "is_degenerate_face", "plane_mesh",
    "sphere_mesh", "uv_sphere"]
