"""Parity of scene IO (``scene/io.py``) and OBJ loading (``scene/obj.py``)
with the JAX package, on the CPU: twins of ``tests/test_obj.py`` and of
``tests/test_sharding_io.py:130-151``, and scene files crossing between
the packages both ways, with tables equal bit for bit.
"""
import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu.accel import dense as j_dense
from raycore_tpu.scene import io as j_io
from raycore_tpu.scene import mesh as j_mesh
from raycore_tpu.scene import obj as j_obj
from raycore_tpu.scene.tlas import TLAS as JTLAS
from raycore_tpu_torch.scene import mesh as t_mesh
from raycore_tpu_torch.scene import obj as t_obj
from torch_parity import CPU, assert_static_equal, bits, np_, torch_rays

OBJ = """\
# quad + tri, with vt/vn syntax and a relative index
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
f 1/1/1 2/2/2 3/3/3 4/4/4
f 1//1 2//2 -1//5
"""


@pytest.fixture
def obj_file(tmp_path):
    p = tmp_path / "mesh.obj"
    p.write_text(OBJ)
    return str(p)


def test_python_parser(obj_file):
    v, f, n = t_obj._parse_obj_python(obj_file)
    assert v.shape == (5, 3) and f.shape == (3, 3)
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [0, 1, 4]])
    assert n is not None and n.shape == (5, 3)
    jv, jf, jn = j_obj._parse_obj_python(obj_file)
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    assert np.array_equal(n, jn)


def test_native_matches_python(obj_file):
    """The native parser, built from native/objloader.cpp into the port's
    build directory, against the Python parser (g++ is part of the
    toolchain the port needs)."""
    v1, f1, n1 = t_obj._parse_obj_native(obj_file)
    v2, f2, n2 = t_obj._parse_obj_python(obj_file)
    assert np.array_equal(v1, v2) and np.array_equal(f1, f2)
    assert np.array_equal(n1, n2)
    assert t_obj.BUILD_DIR.name == "_build"
    assert (t_obj.BUILD_DIR / t_obj.LIB_NAME).is_file()


@pytest.mark.parametrize("native", [None, True])
def test_load_obj_traceable(obj_file, native):
    tris = rt.load_obj(obj_file, native=native, device=CPU)
    ref = j_obj.load_obj(obj_file, native=False)
    assert tris.vertices.shape[0] == 3
    for k in ("vertices", "normals", "uv"):
        assert np.array_equal(bits(getattr(ref, k)), bits(getattr(tris, k)))
    r = rt.closest_hit_brute(tris, torch_rays(np.float32([0.5, 0.4, -2.0]),
                                              np.float32([0.0, 0, 1.0])))
    assert bool(r.hit) and float(r.t) == pytest.approx(2.0, abs=1e-5)


def test_load_obj_of_a_written_mesh_gives_equal_tables(tmp_path):
    """A mesh written as OBJ with %.9g reads back bit for bit through both
    parsers, and build_dense on it gives the original's tables."""
    mesh = t_mesh.displaced_grid_mesh(n=12, device=CPU)
    v = np_(mesh.vertices).reshape(-1, 3)
    p = tmp_path / "grid.obj"
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}"
              for i in range(len(v) // 3)]
    p.write_text("\n".join(lines) + "\n")
    a = rt.build_dense(mesh, cluster_size=32)
    for native in (None, True):
        tris = rt.load_obj(str(p), native=native, device=CPU)
        assert np.array_equal(bits(tris.vertices), bits(mesh.vertices))
        b = rt.build_dense(tris, cluster_size=32)
        for k in ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
                  "prims_hot"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_load_obj_native_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        rt.load_obj(str(tmp_path / "none.obj"), native=True, device=CPU)


# --- scene files ------------------------------------------------------

@pytest.fixture(scope="module")
def tlas_pair():
    jm, tm = JTLAS(), rt.TLAS(device=CPU)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    jm.push(j_mesh.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None)
    jm.push(j_mesh.box_mesh(), tr, instance_id=0xFFFFFFF0)
    tm.push(t_mesh.sphere_mesh(radius=1.0, n_theta=12, n_phi=24,
                               device=CPU), None)
    tm.push(t_mesh.box_mesh(device=CPU), tr, instance_id=0xFFFFFFF0)
    return jm.sync(), tm.sync()


def _grid_rays(n):
    xs = np.linspace(-1.5, 4.5, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, np.linspace(-1.5, 1.5, n, dtype=np.float32),
                       indexing="ij")
    o = np.stack([X, Y, np.full_like(X, -4.0)], -1).reshape(-1, 3)
    return o, np.broadcast_to(np.float32([0, 0, 1]), o.shape).copy()


def _dense_equal(a, b):
    for k in ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
              "root_aabb"):
        assert np.array_equal(bits(getattr(a, k)), bits(getattr(b, k))), k
    assert np.array_equal(np_(a.prims_hot), np_(b.prims_hot))
    for k in ("n_prims", "cluster_size", "sub_chunks", "payload_mask"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(a.prims, k)),
                              bits(getattr(b.prims, k))), k
    assert np.array_equal(np_(a.prims.metadata).astype(np.int64),
                          np_(b.prims.metadata).astype(np.int64))


def test_scene_io_roundtrip_tlas(tlas_pair, tmp_path):
    js, ts = tlas_pair
    p = str(tmp_path / "scene.npz")
    rt.save_scene(p, ts)
    loaded = rt.load_scene(p, device=CPU)
    assert_static_equal(js, loaded)
    o, d = _grid_rays(16)
    r1 = rt.closest_hit(ts, torch_rays(o, d), tile_size=64)
    r2 = rt.closest_hit(loaded, torch_rays(o, d), tile_size=64)
    assert torch.equal(r1.hit, r2.hit) and torch.equal(r1.t, r2.t)


def test_scene_io_roundtrip_dense(tmp_path):
    ds = rt.build_dense(t_mesh.displaced_grid_mesh(n=16, device=CPU),
                        cluster_size=32, instance_of=np.arange(450) % 3)
    p = str(tmp_path / "dense.npz")
    rt.save_scene(p, ds)
    loaded = rt.load_scene(p, device=CPU)
    _dense_equal(ds, loaded)
    assert torch.equal(ds.instance_of_prim, loaded.instance_of_prim)
    rays = torch_rays(np.float32([0.1, 0.1, 2.0]), np.float32([0.0, 0, -1.0]))
    r1 = rt.closest_hit_dense(ds, rays, tile=8)
    r2 = rt.closest_hit_dense(loaded, rays, tile=8)
    assert bool(r1.hit) == bool(r2.hit) and float(r1.t) == float(r2.t)
    assert int(r1.instance_idx) == int(r2.instance_idx)


@pytest.mark.parametrize("kind", ["StaticTLAS", "DenseScene"])
def test_scene_files_cross_between_packages(tlas_pair, tmp_path, kind):
    """A file written by either package loads in the other with every
    table equal bit for bit."""
    if kind == "StaticTLAS":
        js, ts = tlas_pair
    else:
        kw = dict(n=16, extent=2.0, amplitude=0.3)
        js = j_dense.build_dense(j_mesh.displaced_grid_mesh(**kw),
                                 cluster_size=32)
        ts = rt.build_dense(t_mesh.displaced_grid_mesh(**kw, device=CPU),
                            cluster_size=32)
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    j_io.save_scene(jp, js)
    rt.save_scene(tp, ts)
    jz, tz = np.load(jp), np.load(tp)
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].dtype == tz[k].dtype, k
        assert np.array_equal(jz[k], tz[k]), k
    from_jax = rt.load_scene(jp, device=CPU)
    from_torch = j_io.load_scene(tp)
    if kind == "StaticTLAS":
        assert_static_equal(from_torch, from_jax)
        assert_static_equal(js, from_jax)
    else:
        _dense_equal(from_torch, from_jax)
        _dense_equal(js, from_jax)


def _legacy_file(tmp_path, ds, variant):
    """The scene written as older files held it."""
    z = dict(np.load(_saved(tmp_path, ds)))
    hot = z["prims_hot"]
    if variant == "float_hot":
        z["prims_hot"] = hot.view(np.float32)
    elif variant == "ten_columns":
        z["prims_hot"] = hot[:, :10]
    elif variant == "no_hot":
        del z["prims_hot"]
    z["statics"] = z["statics"][:2]
    p = str(tmp_path / f"{variant}.npz")
    np.savez(p, **z)
    return p


def _saved(tmp_path, ds):
    p = str(tmp_path / "base.npz")
    rt.save_scene(p, ds)
    return p


@pytest.mark.parametrize("variant", ["float_hot", "ten_columns", "no_hot"])
def test_legacy_dense_files_load_as_jax_loads_them(tmp_path, variant):
    ds = rt.build_dense(t_mesh.displaced_grid_mesh(n=8, device=CPU),
                        cluster_size=32)
    p = _legacy_file(tmp_path, ds, variant)
    ref = j_io.load_scene(p)
    got = rt.load_scene(p, device=CPU)
    assert np.array_equal(np.asarray(ref.prims_hot), np_(got.prims_hot))
    assert (got.sub_chunks, got.payload_mask) == (4, 0b111)
    assert (ref.sub_chunks, ref.payload_mask) == (4, 0b111)
    if variant == "float_hot":
        assert torch.equal(got.prims_hot, ds.prims_hot)
