"""What the port promises beyond its numbers: it imports no JAX, CPU
tensors never reach a kernel, a CUDA-less host gets no result from
chip_smoke.py, and the kernel wrappers raise rather than fall back."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import raycore_tpu_torch as rt
from raycore_tpu_torch import convert
from raycore_tpu_torch.kernels import _build
from raycore_tpu_torch.ops import brute as ops_brute
from raycore_tpu_torch.ops import dense as ops_dense
from raycore_tpu_torch.ops import regroup as ops_regroup

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_import_pulls_in_no_jax():
    code = ("import sys, raycore_tpu_torch, raycore_tpu_torch.convert, "
            "raycore_tpu_torch.kernels._build\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'raycore_tpu.'))]\n"
            "print('JAXMODS', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAXMODS []" in out.stdout


def test_port_sources_never_import_jax():
    for p in (REPO / "raycore_tpu_torch").rglob("*.py"):
        text = p.read_text()
        assert "import jax" not in text and "from jax" not in text, p
    text = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in text and "raycore_tpu." not in text


KERNELS = (ops_dense.phase_a, ops_regroup.run_regrouped,
           ops_dense.run_worklist, ops_dense.run_occlusion,
           ops_regroup.run_packed, ops_brute.run_brute,
           ops_regroup.refine_pairs)


def test_cpu_tensors_leave_launch_counters_at_zero():
    """Every query path on CPU tensors: the regrouped engine (K1, K7, K2),
    the worklist closest hit (K3), the worklist occlusion (K4), the packed
    engine (K1, K7, K5) and the dense brute-force sweep (K6)."""
    for fn in KERNELS:
        fn.launches = 0
    mesh = rt.displaced_grid_mesh(n=12, device="cpu")
    scene = rt.build_dense(mesh, cluster_size=32)
    scene4 = rt.build_dense(mesh, cluster_size=32, sub_chunks=4)
    rng = np.random.default_rng(0)
    o = torch.as_tensor(rng.uniform(-0.9, 0.9, (300, 3)), dtype=torch.float32)
    o[:, 2] = 2.0
    rays = rt.Ray.create(o, torch.tensor([0, 0, -1.0]))
    for res in (rt.closest_hit(scene, rays),
                ops_regroup.closest_hit_regrouped(scene, rays, tile=2048),
                rt.any_hit(scene, rays),
                ops_regroup.any_hit_regrouped(scene, rays),
                rt.closest_hit_packed(scene4, rays),
                rt.closest_hit_brute_pallas(mesh, rays)):
        assert bool(res.hit.all())
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_entry_points_default_to_the_card():
    """Without a card the default device raises instead of making CPU
    tensors; with device="cpu" the same call runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.displaced_grid_mesh(n=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.Ray.create([0.0, 0.0, 1.0], [0.0, 0.0, -1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.ray_from_numpy(np.zeros((2, 3)), np.ones((2, 3)),
                               np.zeros(2), np.ones(2))
    assert rt.displaced_grid_mesh(n=4, device="cpu").vertices.device.type \
        == "cpu"
    # A tensor input keeps its own device.
    assert rt.Ray.create(torch.zeros(3), torch.ones(3)).o.device.type == "cpu"


def test_wrappers_raise_for_tensors_off_the_cpu_and_cuda():
    """A tensor that is not on the CPU takes the kernel path or raises;
    nothing falls back to the plain version."""
    stats = torch.zeros((4, 16), device="meta")
    bounds = torch.zeros((6, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops_dense.phase_a(stats, bounds)
    tbl = torch.zeros((3, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops_regroup.run_regrouped(
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"), tbl,
            torch.zeros((2, 16, 64), device="meta"), G=8, SPB=2, C=16)
    ids = torch.zeros((1,), dtype=torch.int32, device="meta")
    phi = torch.zeros((128, 16), device="meta")
    rows = torch.zeros((128,), device="meta")
    feats = torch.zeros((2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops_dense.run_worklist(ids, ids, phi, feats,
                               torch.zeros((2, 1, 128), device="meta"), rows,
                               torch.zeros((128,), dtype=torch.int32,
                                           device="meta"),
                               TILE=128, C=16, SUB=1)
    with pytest.raises(ValueError, match="CUDA"):
        ops_dense.run_occlusion(ids, ids, phi, feats, rows, rows, TILE=128,
                                C=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops_regroup.run_packed(
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"), tbl,
            torch.zeros((2, 16, 64), device="meta"), G=8, SPB_sub=2,
            PACKS=4, C_eff=4, SUBC=4)
    ray3 = torch.zeros((128, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops_brute.run_brute(torch.zeros((9, 512), device="meta"), ray3, ray3,
                            rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        ops_regroup.refine_pairs(torch.zeros((8, 14), device="meta"), ids,
                                 ids, ray3, ray3, 4, 2)


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    assert _build.find_nvcc() == str(fake)


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """With a stand-in nvcc: one compile per source and one link, the
    library stamped with the sources' hash and reused while they match,
    and a failing compile raised with its output and no library left."""
    log = tmp_path / "log"
    fake = tmp_path / "nvcc"
    fake.write_text(f'#!/bin/sh\necho "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", fake)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = _build.build()
    assert path.read_text() == "built\n"
    calls = log.read_text().splitlines()
    assert sorted(c.split()[-1] for c in calls if " -c " in c) \
        == sorted(str(p) for p in _build.sources())
    assert [" -shared " in c for c in calls] \
        == [False] * len(_build.sources()) + [True]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) \
        == [_build.LIB_NAME, _build.LIB_NAME + ".sha256"]
    assert _build.build() == path and len(log.read_text().splitlines()) \
        == len(calls)
    path.unlink()
    fake.write_text("#!/bin/sh\necho broken source\nexit 2\n")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build()
    assert not path.exists()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_probe_tools_pull_in_no_jax():
    """The card probes import no JAX and nothing of the JAX package."""
    code = ("import sys\n"
            "from raycore_tpu_torch.tools import gather_probe, "
            "epilogue_experiments, probe_matmul_shapes, "
            "probe_block_overhead\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'raycore_tpu.'))]\n"
            "print('JAXMODS', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAXMODS []" in out.stdout


def test_probe_wrappers_on_cpu_and_meta_tensors():
    """The probes' wrappers take their plain versions for CPU tensors and
    launch nothing; a tensor on neither the CPU nor a card raises."""
    from raycore_tpu_torch.tools import epilogue_experiments as t_epi
    from raycore_tpu_torch.tools import gather_probe as t_gather
    from raycore_tpu_torch.tools import probe_block_overhead as t_block
    from raycore_tpu_torch.tools import probe_matmul_shapes as t_mm
    probes = (t_gather.run_gather, t_epi.run_epilogue, t_mm.run_matmul,
              t_block.run_block)
    for fn in probes:
        fn.launches = 0
    idx, tbl = t_gather.make_inputs(64, 2, device="cpu")
    assert t_gather.run_gather(idx, tbl, "take").shape == (2, 128)
    phi, feats, tmin, key0 = t_epi.make_inputs(16, n_tiles=2, device="cpu")
    assert t_epi.run_epilogue(phi, feats, tmin, key0, TILE=16, n_blocks=2,
                              variant="full").shape == (32, 1)
    a, b = t_mm.operands(128, 16, 64, torch.float32, "cpu")
    assert t_mm.run_matmul(a, b, 2, "high").shape == (128, 1)
    tbl, feats, gen = t_block.make_inputs(n_sub=8, K=2, device="cpu")
    subs, cids = t_block.block_ids(2, 8, 8, 2, gen)
    assert t_block.run_block("full", 32, 8, subs, cids, tbl,
                             feats)[0].shape == (512, 1)
    assert [fn.launches for fn in probes] == [0] * 4
    meta = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                      device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_gather.run_gather(meta(1024, dtype=torch.int32), meta(64, 128),
                            "loop")
    with pytest.raises(ValueError, match="CUDA"):
        t_epi.run_epilogue(meta(32, 16), meta(2, 16, 512), meta(32, 1),
                           meta(32, 1, dtype=torch.int32), TILE=16,
                           n_blocks=2, variant="full")
    with pytest.raises(ValueError, match="CUDA"):
        t_mm.run_matmul(meta(128, 16), meta(16, 64), 2, "highest")
    with pytest.raises(ValueError, match="CUDA"):
        t_block.run_block("full", 32, 8, meta(16, dtype=torch.int32),
                          meta(2, dtype=torch.int32), meta(9, 32, 16),
                          meta(2, 16, 512))


def test_probe_mains_need_the_card():
    """Each probe's main() makes its tensors on the card and raises
    without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the probes run for real")
    from raycore_tpu_torch.tools import epilogue_experiments as t_epi
    from raycore_tpu_torch.tools import gather_probe as t_gather
    from raycore_tpu_torch.tools import probe_block_overhead as t_block
    from raycore_tpu_torch.tools import probe_matmul_shapes as t_mm
    for main in (t_gather.main, t_epi.main, t_mm.main, t_block.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


def _small_query(sub_chunks=1):
    mesh = rt.displaced_grid_mesh(n=12, device="cpu")
    scene = rt.build_dense(mesh, cluster_size=32, sub_chunks=sub_chunks)
    rng = np.random.default_rng(1)
    o = torch.as_tensor(rng.uniform(-0.9, 0.9, (200, 3)), dtype=torch.float32)
    o[:, 2] = 2.0
    return scene, rt.Ray.create(o, torch.tensor([0, 0, -1.0]))


@pytest.mark.parametrize("query", ["closest_hit", "any_hit"])
def test_query_arguments_of_the_reference(monkeypatch, query):
    """The JAX package's query arguments on a DenseScene: ``deferred=True``
    returns (result, None), since every query here syncs; ``tile_size``
    sets the worklist tile to min(512, max(tile_size, 8)), 512 at the
    default 16384; a traversal option raises TypeError."""
    scene, rays = _small_query()
    fn = getattr(rt, query)
    engine = ("closest_hit_dense_pallas_auto" if query == "closest_hit"
              else "any_hit_dense_pallas_auto")
    real, tiles = getattr(ops_dense, engine), []

    def spy(*a, tile, **kw):
        tiles.append(tile)
        return real(*a, tile=tile, **kw)
    monkeypatch.setattr(ops_dense, engine, spy)
    plain = fn(scene, rays)
    res, fin = fn(scene, rays, deferred=True)
    assert fin is None and torch.equal(res.hit, plain.hit)
    assert torch.equal(res.prim_idx, plain.prim_idx)
    for tile_size in (64, 1, 100000):
        fn(scene, rays, tile_size=tile_size)
    assert tiles == [512, 512, 64, 8, 512]
    with pytest.raises(TypeError, match="stack_size"):
        fn(scene, rays, stack_size=64)
    with pytest.raises(TypeError):
        fn(scene, rays, tile_size=64, deferred=True, max_iters=4)


def test_prewarm_and_warm_capacity():
    """``prewarm`` and ``has_warm_capacity`` under the JAX package's names:
    the port keeps no capacity state, so a sub_chunks == 1 scene counts
    as warm for the regrouped engine and a sub-chunked one does not;
    ``prewarm`` runs no query (no kernel launches) and returns None."""
    assert "prewarm" in rt.__all__ and "has_warm_capacity" in rt.__all__
    scene, _ = _small_query()
    scene4, _ = _small_query(sub_chunks=4)
    assert rt.has_warm_capacity(scene, 1 << 20) is True
    assert rt.has_warm_capacity(scene, 1 << 20, passes="auto",
                                payload="slim", occlusion=True) is True
    assert rt.has_warm_capacity(scene4, 1 << 20) is False
    for fn in KERNELS:
        fn.launches = 0
    assert rt.prewarm(scene, 1 << 20) is None
    assert rt.prewarm(scene4, 1 << 20, engine="packed", packs=8) is None
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
