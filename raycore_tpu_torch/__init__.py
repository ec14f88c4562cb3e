"""raycore_tpu_torch — the ray-triangle intersection engine in PyTorch and
CUDA, beside the JAX package ``raycore_tpu``.

It keeps the JAX package's layout and function names. Entry points make
their tensors on the CUDA card unless the caller passes ``device="cpu"``;
tensors then stay on their device, and a kernel wrapper launches its CUDA
kernel for CUDA tensors and runs the kernel's plain PyTorch version for
CPU tensors. It covers the JAX package's whole public surface:

- the core math (rays, boxes, transforms, quaternions, triangles and
  their tests);
- ``closest_hit`` and ``any_hit`` on a ``DenseScene``: for batches of at
  least 2^19 rays the regrouped engine (sub_chunks == 1; ``passes`` >= 2
  or "auto" runs its ordered multiwave) or the packed sub-cluster engine
  (``closest_hit_packed``, sub_chunks >= 2; ``any_hit`` takes the
  worklist there), and the tile worklist (``closest_hit_dense_pallas*``,
  ``any_hit_dense_pallas_auto``) for smaller batches; plus the dense
  brute-force sweep for small meshes (``closest_hit_brute_pallas``);
  and the reference's plain rounds engine, ``closest_hit_dense`` and
  ``any_hit_dense`` (phase A on K1, then rounds of ``torch.bmm``), with
  ``morton_sort_rays`` to make a batch coherent;
- the two-level BVH: the LBVH build (``build_blas``), the mutable
  ``TLAS`` manager whose ``sync`` gives a ``StaticTLAS``, and the
  traversal that ``closest_hit``/``any_hit`` run on it; the BVH4 layer
  (``build_blas4``, ``closest_hit4``, ``any_hit4``); the accel protocol
  (``TLASAccel``, ``BruteAccel``) and the transport records (``RTRay``,
  ``RTHitResult``, ``trace_closest_hits``, ``trace_any_hits``);
- the instanced engine: ``bake_instanced`` turns a ``TLAS`` into a
  ``DenseInstancedScene``, ``refresh_instances`` follows its transforms
  each frame, and ``closest_hit``/``any_hit`` sweep it with K1 and K2's
  pairrow mode (``ops/instanced.py``); ``bake_dense`` bakes a ``TLAS``
  into one world-space ``DenseScene``;
- the consumers: sampling (``core/sampling.py``), the ``MultiTypeSet``
  (``collections/``), the SoA and config utilities (``utils/``), the
  wavefront renderer, the path tracer and its staged drivers, the simple
  and MultiTypeSet renderers, the example scenes and the debug images
  (``render/``), and the ray-grid, view-factor and collision analyses
  (``analysis/``). They reach the card only through ``closest_hit`` and
  ``any_hit``. Where the JAX package takes a PRNG key they take a
  ``torch.Generator`` (None: one seeded 0 on the scene's device);
- scene files (``save_scene``/``load_scene``, the JAX package's ``.npz``
  format) and OBJ loading (``load_obj``);
- the two-phase interval classifier (``ops/two_phase.py``);
- ray sharding over ``torch.distributed`` (``sharding``: the scene
  replicated, rays sharded, results gathered on every rank) and its dry
  run in gloo ranks (``parallel/dryrun.py``).

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
from .accel.dense import (DenseScene, any_hit_dense, build_dense,
                          closest_hit_dense, depth_layers, morton_sort_rays)
from .accel.wide import (BLAS4, TLAS4, any_hit4, build_blas4, closest_hit4,
                         collapse_blas)
from .accel.transport import (RTHitResult, RTRay, trace_any_hits,
                              trace_closest_hits)
from .accel.protocol import AbstractAccel, BruteAccel, TLASAccel
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
from .scene.obj import load_obj
from .scene.io import load_scene, save_scene
from .scene.instanced import (DenseInstancedScene, bake_instanced,
                              refresh_instances)
from .scene.mesh import (blobby_mesh, box_mesh, build_triangle,
                         build_triangles, displaced_grid_mesh,
                         is_degenerate_face, plane_mesh, sphere_mesh,
                         uv_sphere)
from .core import sampling
from .core.sampling import reflect
from .collections.multitypeset import (MultiTypeSet, SetKey,
                                       StaticMultiTypeSet, TexturePool, deref,
                                       is_invalid, is_valid_key,
                                       maybe_convert_field, sample_bilinear,
                                       sample_nearest, texture_to_numpy,
                                       to_tuple, with_index)
from .analysis.kernels import (RayHits, generate_ray_grid, get_centroid,
                               get_illumination, hits_from_grid,
                               view_factors)
from .analysis.collision import (CollisionResult, collide_instances,
                                 collide_instances_any)
from .render.wavefront import (Camera, Materials, PointLights, RenderConfig,
                               WavefrontRenderer, render_step)
from .render.scenes import example_scene, particle_scene
from .render.pathtracer import PTConfig, trace_paths
from .render.debug_viz import (RayIntersectionResult, ray_plot, save_png,
                               save_ppm, scene_preview, trace_rays)
from .utils.soa import (for_unrolled, map_unrolled, reduce_unrolled,
                        similar_soa, soa_get, soa_set, sum_unrolled,
                        switch_apply)
from .parallel import sharding

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
    "build_dense", "depth_layers", "closest_hit_dense", "any_hit_dense",
    "morton_sort_rays",
    "BLAS4", "TLAS4", "build_blas4", "collapse_blas", "closest_hit4",
    "any_hit4", "RTRay", "RTHitResult", "trace_closest_hits",
    "trace_any_hits", "AbstractAccel", "TLASAccel", "BruteAccel",
    "load_obj", "save_scene", "load_scene", "closest_hit", "any_hit", "prewarm",
    "has_warm_capacity", "closest_hit_regrouped", "any_hit_regrouped",
    "auto_passes", "closest_hit_packed", "closest_hit_dense_pallas",
    "closest_hit_dense_pallas_auto", "closest_hit_dense_pallas_topk",
    "any_hit_dense_pallas_auto", "closest_hit_brute_pallas",
    "blobby_mesh", "box_mesh", "build_triangle", "build_triangles",
    "displaced_grid_mesh", "is_degenerate_face", "plane_mesh",
    "sphere_mesh", "uv_sphere",
    "sampling", "reflect",
    "MultiTypeSet", "StaticMultiTypeSet", "SetKey", "TexturePool",
    "with_index", "is_invalid", "is_valid_key", "sample_nearest",
    "sample_bilinear", "deref", "to_tuple", "maybe_convert_field",
    "texture_to_numpy",
    "RayHits", "generate_ray_grid", "hits_from_grid", "get_centroid",
    "get_illumination", "view_factors",
    "CollisionResult", "collide_instances", "collide_instances_any",
    "WavefrontRenderer", "RenderConfig", "Materials", "PointLights",
    "Camera", "render_step", "example_scene", "particle_scene",
    "PTConfig", "trace_paths",
    "RayIntersectionResult", "trace_rays", "scene_preview", "ray_plot",
    "save_ppm", "save_png",
    "soa_get", "soa_set", "similar_soa", "for_unrolled", "map_unrolled",
    "reduce_unrolled", "sum_unrolled", "switch_apply", "sharding"]
