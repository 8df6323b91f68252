"""The port's stage cache against the JAX package's (``pipeline/stagecache.py``).

Exact: ``digest_arrays`` and ``key()`` give the same hex in both packages
for the same arrays, digests, files and config JSON; ``sweep_tmp`` removes
the same files in both. Within the port: a corrupt entry (unreadable, or a
payload whose digest no longer matches) is evicted and reads as a miss; a
failed ``put`` (an injected ``cache.put`` fault) raises nothing and leaves no
file. Across the packages: the port's view keys carry its engine tag, so a
``.slscan-cache`` the JAX package wrote for the same frames, calibration and
config is all misses for the port's view stage (and with the tag taken out
the keys would be the JAX package's).
"""
import json
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import load_config as jload
from structured_light_for_3d_model_replication_tpu.io import atomic as jatomic
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.pipeline.stagecache import (
    StageCache as JStageCache,
)
from structured_light_for_3d_model_replication_tpu.pipeline.stagecache import (
    config_subtree as jconfig_subtree,
)
from structured_light_for_3d_model_replication_tpu_torch.config import load_config
from structured_light_for_3d_model_replication_tpu_torch.io import atomic
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
    config_subtree,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

STEPS = ("background", "cluster", "radius", "statistical")
OVERRIDES = {"decode.n_cols": "128", "decode.n_rows": "64"}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"points": rng.normal(0, 50, (300, 3)).astype(np.float32),
            "colors": rng.integers(0, 256, (300, 3), dtype=np.uint8),
            "faces": rng.integers(0, 300, (40, 3), dtype=np.int32)}


def test_digests_and_keys_match_the_jax_package(tmp_path):
    arrs = _arrays()
    assert StageCache.digest_arrays(**arrs) == JStageCache.digest_arrays(**arrs)
    files = []
    for i, n in enumerate((0, 17, 4096)):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(np.random.default_rng(i).integers(0, 256, n, np.uint8).tobytes())
        files.append(str(p))
    port, jax = StageCache(str(tmp_path / "p")), JStageCache(str(tmp_path / "j"))
    kw = dict(files=files, digests=["ab" * 32, "cd" * 32], arrays=arrs,
              config_json=json.dumps({"merge": {"voxel_size": 3.0}}))
    for stage in ("view", "pair", "merge", "mesh"):
        assert port.key(stage, **kw) == jax.key(stage, **kw)
    assert port.keys_parallel("view", [files[:1], files], "{}", io_workers=2) == \
        jax.keys_parallel("view", [files[:1], files], "{}", io_workers=2)
    # the config subtree is the JAX package's JSON for the sections both carry
    cfg, jcfg = load_config(), jload()
    for sections in (("decode", "triangulate", "projector", "clean"), ("mesh",)):
        assert config_subtree(cfg, sections) == jconfig_subtree(jcfg, sections)


@pytest.mark.parametrize("damage", ["truncated", "digest"])
def test_a_corrupt_entry_is_evicted_and_reads_as_a_miss(tmp_path, damage):
    logs = []
    cache = StageCache(str(tmp_path / "c"), log=logs.append)
    key = cache.key("view", config_json="x")
    cache.put("view", key, **_arrays())
    path = cache._path("view", key)
    if damage == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:   # the recorded digest no longer matches the arrays (bit rot)
        with np.load(path) as z:
            payload = dict(z)
        payload["points"][0, 0] += 1.0
        np.savez(path[:-4], **payload)
    assert cache.get("view", key) is None
    assert not os.path.exists(path)
    assert cache.stats()["evicted"] == 1 and cache.stats()["misses"] == 1
    assert any("evicted" in m for m in logs)
    cache.put("view", key, **_arrays())
    got = cache.get("view", key)
    np.testing.assert_array_equal(got["points"], _arrays()["points"])


def test_a_failed_put_is_best_effort(tmp_path):
    faults.configure("cache.put:permanent")
    try:
        cache = StageCache(str(tmp_path / "c"), log=lambda m: None)
        key = cache.key("mesh", config_json="y")
        cache.put("mesh", key, **_arrays())
    finally:
        faults.reset()
    assert cache.stats()["put_errors"] == 1
    assert os.listdir(tmp_path / "c") == []
    assert cache.get("mesh", key) is None
    disabled = StageCache(str(tmp_path / "off"), enabled=False)
    disabled.put("mesh", key, **_arrays())
    assert disabled.get("mesh", key) is None and not os.path.exists(tmp_path / "off")


def test_sweep_tmp_removes_orphans_as_the_jax_package(tmp_path):
    names = ["a.tmp", "b.tmp.npz", "keep.ply", "keep.npz", "sub/c.tmp", "sub/keep.tmpx"]
    removed = {}
    for pkg, mod in (("port", atomic), ("jax", jatomic)):
        root = tmp_path / pkg
        for n in names:
            (root / n).parent.mkdir(parents=True, exist_ok=True)
            (root / n).write_bytes(b"x")
        flat = mod.sweep_tmp(str(root))
        deep = mod.sweep_tmp(str(root), recursive=True)
        removed[pkg] = (sorted(os.path.relpath(p, root) for p in flat),
                        sorted(os.path.relpath(p, root) for p in deep),
                        sorted(os.path.relpath(os.path.join(r, f), root)
                               for r, _, fs in os.walk(root) for f in fs))
    assert removed["port"] == removed["jax"]
    assert removed["port"][0] == ["a.tmp", "b.tmp.npz"]
    assert removed["port"][1] == ["sub/c.tmp"]
    assert atomic.sweep_tmp(str(tmp_path / "missing")) == []
    # a cache sweeps its own root when it opens
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "view-0.npz.tmp").write_bytes(b"x")
    StageCache(str(tmp_path / "c"))
    assert os.listdir(tmp_path / "c") == []


def test_a_jax_written_cache_is_all_misses_for_the_port_view_stage(tmp_path):
    rig, _, _ = syn.pipeline_scene(cam_size=(40, 30), proj_size=(128, 64), n_views=3)
    calib = str(tmp_path / "calib.npz")
    matfile.save_calibration(calib, rig.calibration())
    n = gc.frames_per_view(128, 64, 1)
    for i in range(3):
        frames = np.random.default_rng(i).integers(0, 256, (n, 30, 40), np.uint8)
        imio.save_packed_stack(str(tmp_path / "scans" / f"view_{i * 15:03d}deg"),
                               imio.pack_stack(frames))
    root = str(tmp_path / ".slscan-cache")
    jcache = JStageCache(root)
    jcfg = jload(None, OVERRIDES)
    _, srcs, _, jkeys = jstages._view_plan(calib, str(tmp_path / "scans"), jcfg, STEPS,
                                           jcache, lambda *a: None)
    for k in jkeys:
        jcache.put("view", k, **_arrays())
    cache = StageCache(root)
    _, sources, keys, _ = stages._view_plan(calib, str(tmp_path / "scans"),
                                            load_config(None, OVERRIDES), STEPS, cache,
                                            lambda m: None, torch.device("cpu"))
    assert sources == srcs and len(keys) == 3
    assert all(cache.get("view", k) is None for k in keys)
    assert cache.stats()["misses"] == 3 and cache.stats()["hits"] == 0
    assert len(os.listdir(root)) == 3   # the JAX package's entries stay
    # the engine tag is all that separates the two: the JAX package's own
    # view config (its backend in the tag's place) gives its keys
    view_cfg = config_subtree(jcfg, ("decode", "triangulate", "projector", "clean")) + \
        json.dumps({"steps": list(STEPS), "backend": jcfg.parallel.backend})
    assert cache.keys_parallel("view", [[calib] + imio.list_frame_files(s) for s in sources],
                               config_json=view_cfg) == jkeys
