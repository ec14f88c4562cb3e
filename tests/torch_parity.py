"""Inputs shared by the port's parity tests (tests/test_torch_*.py).

Inputs are NumPy arrays made from a seed and handed to both packages; the
JAX package runs on the CPU with its Pallas kernels in interpret mode, the
port on CPU tensors (so its kernel wrappers take their plain versions).
``check_hits`` is the JAX package's own engine contract
(tests/test_pallas_regroup.py:_check).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

import raycore_tpu as rc
import raycore_tpu_torch as rt
from raycore_tpu.scene import mesh as _j_mesh
from raycore_tpu.scene.tlas import TLAS as _JTLAS
from raycore_tpu_torch.scene import mesh as _t_mesh
from test_pallas_regroup import _check as check_hits  # noqa: F401

CPU = torch.device("cpu")   # the port's entry points default to the card

torch.set_num_threads(2)
# Full float32 in any matrix product the plain versions run on a card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def ray_arrays(R=1024, seed=0, coherent=False, zero_dirs=False):
    """(o, d) float32 as tests/test_pallas_regroup.py makes them: a
    downward grid over [-0.9, 0.9]^2 (coherent) or random downward rays.
    zero_dirs puts exact zeros, -0.0 and tiny components into d, so that
    safe_invdir clamps and phase A's widening branch runs."""
    rng = np.random.default_rng(seed)
    if coherent:
        side = int(np.sqrt(R))
        xs = np.linspace(-0.9, 0.9, side, dtype=np.float32)
        X, Y = np.meshgrid(xs, xs, indexing="ij")
        o = np.stack([X, Y, np.full_like(X, 3.0)], -1).reshape(-1, 3)
        d = np.broadcast_to(np.array([0, 0, -1], np.float32), o.shape).copy()
    else:
        o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
        o[:, 2] = 2.0
        d = rng.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[:, 2] = -np.abs(d[:, 2]) - 0.3
    if zero_dirs:
        d[::7, 0] = 0.0
        d[1::7, 1] = -0.0
        d[2::7, 0] = 3e-6
        d[3::7, 1] = -1e-5
    return o, np.ascontiguousarray(d)


def jax_rays(o, d, **kw):
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d), **kw)


def torch_rays(o, d, **kw):
    return rt.Ray.create(torch.as_tensor(o), torch.as_tensor(d), **kw)


def jax_scene_arrays(scene) -> dict:
    """A JAX DenseScene as the dict raycore_tpu_torch.convert takes."""
    out = {k: np.asarray(getattr(scene, k)) for k in
           ("tri_feats", "cluster_min", "cluster_max", "sub_bounds",
            "prims_hot", "root_aabb")}
    out.update({k: np.asarray(getattr(scene.prims, k)) for k in
                ("vertices", "normals", "tangents", "uv", "metadata")})
    out.update(n_prims=scene.n_prims, cluster_size=scene.cluster_size,
               sub_chunks=scene.sub_chunks, payload_mask=scene.payload_mask)
    return out


def _prim_arrays(prims) -> dict:
    return {k: np.asarray(getattr(prims, k)) for k in
            ("vertices", "normals", "tangents", "uv", "metadata")}


def jax_blas_arrays(blas) -> dict:
    """A JAX BLAS as the dict ``convert.blas_from_numpy`` takes."""
    return dict(nodes=np.asarray(blas.nodes),
                root_aabb=np.asarray(blas.root_aabb),
                n_prims=blas.n_prims, capacity=blas.capacity,
                **_prim_arrays(blas.prims))


def jax_static_tlas_arrays(tlas) -> dict:
    """A JAX StaticTLAS as the dict ``convert.static_tlas_from_numpy``
    takes."""
    out = {k: np.asarray(getattr(tlas, k)) for k in
           ("unified_nodes", "blas_nodes_offset", "blas_prims_offset",
            "blas_root_aabb", "root_aabb")}
    out.update({k: np.asarray(getattr(tlas.instances, k)) for k in
                ("transform", "inv_transform", "blas_index", "instance_id",
                 "mask")})
    out.update(_prim_arrays(tlas.prims), n_instances=tlas.n_instances,
               instance_capacity=tlas.instance_capacity, n_blas=tlas.n_blas)
    return out


def jax_instanced_arrays(scene) -> dict:
    """A JAX DenseInstancedScene as the dict
    ``convert.instanced_scene_from_numpy`` takes."""
    out = {k: np.asarray(getattr(scene, k)) for k in
           ("tri_feats", "cluster_min", "cluster_max", "prims_hot",
            "inst_inv", "inst_blas", "inst_cbase", "inst_ncl",
            "inst_aabb_min", "inst_aabb_max", "inst_local_min",
            "inst_local_max", "root_aabb")}
    out.update(_prim_arrays(scene.prims), n_instances=scene.n_instances,
               cluster_size=scene.cluster_size,
               max_clusters_per_blas=scene.max_clusters_per_blas,
               payload_mask=scene.payload_mask)
    return out


def np_(x):
    """NumPy view of a JAX array or a CPU tensor."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bits(x):
    """int32 bit pattern of a float32 array or tensor."""
    return np_(x).view(np.int32)


def assert_ray_features_close(ref, got, o, d):
    """(R, 16) ray feature rows of the reference and the port. The port
    computes o x d (cols 3:6) in plain float32, while the reference's
    compiler fuses one product of each component into an FMA: the two
    differ by the rounding of that product plus the final rounding, at
    most 2 ulp of the larger product. Every other column is bitwise
    equal."""
    ref, got = np_(ref), np_(got)
    rest = [c for c in range(ref.shape[1]) if c not in (3, 4, 5)]
    assert np.array_equal(bits(ref[:, rest]), bits(got[:, rest]))
    ao, ad = np.abs(o), np.abs(d)
    mag = (ao[:, [1, 2, 0]] * ad[:, [2, 0, 1]]
           + ao[:, [2, 0, 1]] * ad[:, [1, 2, 0]])
    assert (np.abs(got[:, 3:6] - ref[:, 3:6]) <= 2.0 ** -22 * mag).all()


def worklist_tie_rtol(bits: int) -> float:
    """Relative t tie bound of the tile worklist: its keys keep 23 - bits
    mantissa bits of t, so two hits within 2^-(23 - bits) relative of each
    other tie on the key and the smaller lane wins; the exact finalize then
    reports that triangle's own t. Plus the 2e-6 of the engine contract."""
    return 2.0 ** -(23 - bits) + 2e-6


def check_worklist_hits(ref, got, bits: int):
    """``check_hits`` with the worklist's widened bound: equal hit masks;
    t within rtol max(2e-5, worklist_tie_rtol(bits)) and atol 2e-6 where
    both hit; a differing prim only as a t tie within
    worklist_tie_rtol(bits); most prims equal."""
    tie = worklist_tie_rtol(bits)
    h = np_(ref.hit)
    assert np.array_equal(h, np_(got.hit))
    rt_, gt = np_(ref.t)[h], np_(got.t)[h]
    np.testing.assert_allclose(gt, rt_, rtol=max(2e-5, tie), atol=2e-6)
    pm = np_(ref.prim_idx)[h] == np_(got.prim_idx)[h]
    assert not pm.size or pm.mean() >= 0.7
    if not pm.all():
        rel = np.abs(gt[~pm] - rt_[~pm]) / np.maximum(rt_[~pm], 1e-6)
        assert rel.max() < tie


def pallas_dense_scenes(blobby=False, SUB=1, instances=0):
    """(JAX scene, port scene) at tests/test_pallas_dense.py's sizes:
    ``displaced_grid_mesh(n=32)`` at C=64 or ``blobby_mesh(64, 64)`` at
    C=128; with ``instances`` > 0 every triangle gets instance slot
    (index % instances)."""
    from raycore_tpu.accel import dense as j_dense
    from raycore_tpu.scene import mesh as j_mesh
    from raycore_tpu_torch.scene import mesh as t_mesh
    if blobby:
        jm, tm = j_mesh.blobby_mesh(64, 64), \
            t_mesh.blobby_mesh(64, 64, device=CPU)
        C = 128
    else:
        kw = dict(n=32, extent=2.0, amplitude=0.3)
        jm, tm = j_mesh.displaced_grid_mesh(**kw), \
            t_mesh.displaced_grid_mesh(**kw, device=CPU)
        C = 64
    inst = (np.arange(tm.vertices.shape[0], dtype=np.int32) % instances
            if instances else None)
    return (j_dense.build_dense(jm, cluster_size=C, sub_chunks=SUB,
                                instance_of=inst),
            rt.build_dense(tm, cluster_size=C, sub_chunks=SUB,
                           instance_of=inst))


def jax_tile_padded(a, fill, TILE, column=False):
    """A port worklist operand as the JAX kernels take it: a trailing dummy
    tile of ``fill`` rows (the JAX kernels treat it as padding; the port
    has none), as an (R, 1) column when ``column``."""
    a = np_(a)
    a = np.concatenate([a, np.full((TILE,) + a.shape[1:], fill, a.dtype)])
    return jnp.asarray(a[:, None] if column else a)


def jax_worklist_args(tids, cids, phi, tmin, key0, pair0, TILE):
    """The port's worklist operands as JAX's ``_run_worklist`` takes them
    (zero features, t_min 0, key 0 and pair -1 in the dummy tile)."""
    return (jnp.asarray(np_(tids)), jnp.asarray(np_(cids)),
            jax_tile_padded(phi, 0.0, TILE),
            jax_tile_padded(tmin, 0.0, TILE, column=True),
            jax_tile_padded(key0, 0, TILE, column=True),
            jax_tile_padded(pair0, -1, TILE, column=True))


def spy(monkeypatch, module, name, calls):
    """Record (name, keyword arguments) of every call of ``module.name``
    into ``calls``; the call still runs."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append((name, kw))
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)


# --- the TLAS manager and instanced scenes on both packages ------------


def sphere_of(pkg, radius=1.0, nt=8, nphi=16):
    kw = {} if pkg is _j_mesh else {"device": CPU}
    return pkg.sphere_mesh(radius=radius, n_theta=nt, n_phi=nphi, **kw)


def box_of(pkg, **kw):
    return pkg.box_mesh(**kw) if pkg is _j_mesh else pkg.box_mesh(
        **kw, device=CPU)


def translation(x, y=0.0, z=0.0):
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (x, y, z)
    return m


def random_transform(rng, scale_lo=0.4, scale_hi=1.2, span=3.0):
    """tests/test_instanced_engine.py:_transform."""
    s = rng.uniform(scale_lo, scale_hi)
    th = rng.uniform(0, 2 * np.pi)
    c, sn = np.cos(th), np.sin(th)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32) * s
    m[:, 3] = rng.uniform(-span, span, 3).astype(np.float32)
    return m


class Twin:
    """The same mutations on a JAX manager and on the port's."""

    def __init__(self):
        self.j, self.t = _JTLAS(), rt.TLAS(device=CPU)

    def push(self, mesh, *a, **kw):
        hj = self.j.push(mesh(_j_mesh), *a, **kw)
        ht = self.t.push(mesh(_t_mesh), *a, **kw)
        assert hj.id == ht.id
        return ht

    def update(self, handle, mesh):
        self.j.update(handle, mesh(_j_mesh))
        self.t.update(handle, mesh(_t_mesh))

    def __getattr__(self, name):
        def both(*a, **kw):
            getattr(self.j, name)(*a, **kw)
            return getattr(self.t, name)(*a, **kw)
        return both

    def sync(self):
        js, ts = self.j.sync(), self.t.sync()
        assert_static_equal(js, ts)
        return js, ts


def assert_static_equal(js, ts):
    for k in ("n_instances", "instance_capacity", "n_blas"):
        assert getattr(js, k) == getattr(ts, k), k
    for k in ("unified_nodes", "blas_nodes_offset", "blas_prims_offset"):
        assert np.array_equal(np_(getattr(js, k)), np_(getattr(ts, k))), k
    for k in ("blas_root_aabb", "root_aabb"):
        assert np.array_equal(bits(getattr(js, k)), bits(getattr(ts, k))), k
    for k in ("transform", "inv_transform"):
        assert np.array_equal(bits(getattr(js.instances, k)),
                              bits(getattr(ts.instances, k))), k
    for k in ("blas_index", "instance_id", "mask"):
        assert np.array_equal(np_(getattr(js.instances, k)).astype(np.int64),
                              np_(getattr(ts.instances, k)).astype(np.int64)), k
    for k in ("vertices", "normals", "tangents", "uv"):
        assert np.array_equal(bits(getattr(js.prims, k)),
                              bits(getattr(ts.prims, k))), k
    assert np.array_equal(np_(js.prims.metadata).astype(np.int64),
                          np_(ts.prims.metadata))


def instanced_twin(n_inst=12, seed=1234):
    """tests/test_instanced_engine.py:_scene on both packages."""
    rng = np.random.default_rng(seed)
    tw = Twin()
    for i in range(n_inst):
        mesh = sphere_of if i == 0 or i % 2 == 1 else box_of
        tw.push(mesh, random_transform(rng))
    return tw, rng


def engine_rays(rng, n=2048, span=4.5):
    """tests/test_instanced_engine.py:_rays as NumPy (o, d)."""
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    o[:, 2] = -6.0
    tgt = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


# --- the renderers' random draws and state on both packages -------------


class JaxDraws:
    """A JAX PRNG key passed where the port takes a torch.Generator. With
    ``feed_jax_draws`` the port's draw helpers split it as the JAX
    package's ``schedule`` does, so both packages draw the same numbers:
    "wave" (wavefront.py: the key itself for the pixel jitter, fold_in(key,
    1) for the roughness), "path" (pathtracer.py: split(key) for the
    primary rays, then split(fk, 4) each bounce), "simple" (simple.py:
    split(key) into the jitter's and the kernel's keys), "batches"
    (view_factors: split(key) each batch, then split(sub)) and "plain"
    (sampling: the key itself)."""

    def __init__(self, key, schedule):
        self.key, self.schedule = key, schedule

    def _t(self, x, device, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    def pixel_jitter(self, H, W, spp, device):
        key = self.key
        if self.schedule == "path":
            self.key, key = jax.random.split(self.key)
        return self._t(jax.random.uniform(key, (H, W, spp, 2), jnp.float32),
                       device)

    def roughness(self, shape, device):
        k = jax.random.fold_in(self.key, 1)
        return self._t(jax.random.uniform(k, tuple(shape), jnp.float32),
                       device)

    def bounce(self, R, n_lights, device):
        self.key, kl, kb, kr = jax.random.split(self.key, 4)
        return (self._t(jax.random.randint(kl, (R,), 0, n_lights), device,
                        torch.int64),
                self._t(jax.random.uniform(kb, (R, 3)), device),
                self._t(jax.random.normal(kr, (R, 3)), device))

    def simple_keys(self):
        return jax.random.split(self.key)

    def primary(self, H, W, spp, device):
        if spp > 1:
            return self._t(jax.random.uniform(
                self.simple_keys()[0], (H, W, spp, 2), jnp.float32), device)
        return torch.full((H, W, 1, 2), 0.5, device=device)

    def disk(self, S, R, device):
        return self._t(jax.random.uniform(self.simple_keys()[1], (S, R, 2)),
                       device)

    def batch(self, T, B, device):
        self.key, sub = jax.random.split(self.key)
        k1, k2 = jax.random.split(sub)
        return (self._t(jax.random.uniform(k1, (T, B, 2)), device),
                self._t(jax.random.uniform(k2, (T, B, 2)), device))

    def uniform(self, shape, device):
        return self._t(jax.random.uniform(self.key, tuple(shape),
                                          jnp.float32), device)


def feed_jax_draws(monkeypatch):
    """Point every draw helper of the port at a ``JaxDraws`` argument."""
    from raycore_tpu_torch.analysis import kernels as t_ak
    from raycore_tpu_torch.core import sampling as t_s
    from raycore_tpu_torch.render import pathtracer as t_pt
    from raycore_tpu_torch.render import simple as t_simple
    from raycore_tpu_torch.render import wavefront as t_wf
    monkeypatch.setattr(t_wf, "_pixel_jitter",
                        lambda g, H, W, spp, dev: g.pixel_jitter(H, W, spp,
                                                                 dev))
    monkeypatch.setattr(t_wf, "_roughness_draws",
                        lambda g, shape, dev: g.roughness(shape, dev))
    monkeypatch.setattr(t_pt, "_bounce_draws",
                        lambda g, R, L, dev: g.bounce(R, L, dev))
    monkeypatch.setattr(t_simple, "_primary_jitter",
                        lambda g, H, W, spp, dev: g.primary(H, W, spp, dev))
    monkeypatch.setattr(t_simple, "_disk_draws",
                        lambda g, S, R, dev: g.disk(S, R, dev))
    monkeypatch.setattr(t_ak, "_batch_draws",
                        lambda g, T, B, dev: g.batch(T, B, dev))
    monkeypatch.setattr(t_s, "_uniform",
                        lambda g, shape, dev: g.uniform(shape, dev))


def render_state_from_jax(materials, lights, camera):
    """JAX Materials, PointLights and Camera as the port's, on the CPU."""
    from raycore_tpu_torch import convert
    n = lambda a: np.asarray(a)
    return (convert.materials_from_numpy(
                n(materials.base_color), n(materials.metallic),
                n(materials.roughness), n(materials.ior),
                n(materials.transmission), device=CPU),
            convert.point_lights_from_numpy(n(lights.position),
                                            n(lights.intensity), device=CPU),
            convert.camera_from_numpy(n(camera.position), n(camera.target),
                                      n(camera.up), n(camera.fov_deg),
                                      device=CPU))



class _RowNorms:
    """``jax.numpy`` with ``linalg.norm(v, -1, keepdims=True)`` read as the
    per-row norm its callers mean (``axis=-1``); JAX takes the -1 as
    ``ord``, a matrix norm of the whole batch (ROADMAP Q9)."""

    class linalg:
        @staticmethod
        def norm(x, ord=None, axis=None, keepdims=False):
            if ord == -1 and axis is None:
                ord, axis = None, -1
            return jnp.linalg.norm(x, ord, axis, keepdims)

        def __getattr__(self, name):
            return getattr(jnp.linalg, name)

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_row_norms(monkeypatch):
    """Run the JAX renderers with the per-row norms the port decided on
    (ROADMAP Q9): ``jnp`` swapped in render/simple.py, pathtracer.py and
    mts_renderer.py, and their jitted entry points run unjitted so that
    no earlier trace with the matrix norm is reused."""
    from raycore_tpu.render import mts_renderer as jM
    from raycore_tpu.render import pathtracer as jp
    from raycore_tpu.render import simple as jS
    for mod in (jS, jp, jM):
        monkeypatch.setattr(mod, "jnp", _RowNorms())
    for mod, name in ((jp, "trace_paths"), (jp, "_pt_shade_and_sample"),
                      (jM, "render_step_mts")):
        monkeypatch.setattr(mod, name, getattr(mod, name).__wrapped__)
