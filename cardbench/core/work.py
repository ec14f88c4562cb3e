"""The bytes a call needs, fixed by the cell and not by the program:
each input byte read once and each contractual output byte written once
(the least-time numerator of ``roofline_pct``)."""

TRIANGLE_BYTES = 36          # three float32 vertices
RAY_BYTES = 32               # origin, direction, t_min, t_max
TRANSFORM_BYTES = 48         # a float32 3 x 4 matrix
# A closest hit's full payload: hit (1), t (4), barycentric (12), prim and
# instance index (4 + 4), and the triangle: vertices, normals, tangents
# (36 each), uv (24), metadata (8).
CLOSEST_FULL_BYTES = 1 + 4 + 12 + 4 + 4 + 36 * 3 + 24 + 8
# An occlusion answer's contractual fields: hit, prim and instance index.
OCCLUSION_BYTES = 1 + 4 + 4


def query_bytes(n_tris: int, n_rays: int, result_bytes: int) -> int:
    return n_tris * TRIANGLE_BYTES + n_rays * (RAY_BYTES + result_bytes)


def frame_bytes(n_base_tris: int, n_instances: int, n_rays: int,
                result_bytes: int) -> int:
    return (n_base_tris * TRIANGLE_BYTES + n_instances * TRANSFORM_BYTES
            + n_rays * (RAY_BYTES + result_bytes))
