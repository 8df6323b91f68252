"""The port's device mesh (``parallel/mesh.py``) on the CPU.

``make_mesh`` keeps the JAX package's defaults and errors
(``tests/test_parallel_scan.py::test_mesh_shapes``) on a device list that
repeats the CPU, the port's counterpart of XLA's 8 virtual host devices;
``merge_mesh`` and ``views_mesh`` count distinct attached devices, so the
CPU gives None; each collective on ``[cpu] * n`` equals numpy exactly
(integer-valued floats, so the reduction order cannot show).
"""
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.parallel import mesh as jmesh
from structured_light_for_3d_model_replication_tpu_torch.config import ParallelConfig
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_mesh_shapes_and_errors():
    m = meshlib.make_mesh(devices=[CPU] * 8)
    j = jmesh.make_mesh()
    assert m.size == j.devices.size == 8 and m.axis_names == j.axis_names
    assert m.shape == dict(j.shape)
    m2 = meshlib.make_mesh(n_model=4, devices=[CPU] * 8)
    assert m2.devices.shape == jmesh.make_mesh(n_model=4).devices.shape == (2, 4)
    assert meshlib.make_mesh(n_data=2, devices=[CPU] * 8).devices.shape == (2, 4)
    assert meshlib.make_mesh(n_data=1, n_model=3, devices=[CPU] * 8).size == 3
    for kw, what in (({"n_data": 3, "n_model": 3}, "needs more than"),
                     ({"n_model": 3}, "not divisible by n_model"),
                     ({"n_data": 3}, "not divisible by n_data")):
        with pytest.raises(ValueError, match=what):
            meshlib.make_mesh(devices=[CPU] * 8, **kw)
        with pytest.raises(ValueError, match=what):
            jmesh.make_mesh(**kw)
    # the default is every attached device: here the one CPU
    assert [str(d) for d in meshlib.make_mesh().devices.reshape(-1)] == ["cpu"]


def test_merge_and_views_mesh_are_none_on_one_device():
    for cfg in (None, ParallelConfig(merge_mesh=True, shard_views=True), ParallelConfig()):
        assert meshlib.merge_mesh(cfg) is None
        assert meshlib.views_mesh(cfg) is None
    assert ParallelConfig().shard_views is True and ParallelConfig().merge_mesh is False


def test_merge_and_views_mesh_gate_on_distinct_cards(monkeypatch):
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(meshlib, "attached_devices", lambda: list(cards))
    assert meshlib.merge_mesh(ParallelConfig()) is None            # merge_mesh off
    m = meshlib.merge_mesh(ParallelConfig(merge_mesh=True))
    assert m.size == 4 and m.devices.shape == (4, 1)
    assert meshlib.views_mesh(ParallelConfig(shard_views=False)) is None
    assert meshlib.views_mesh(ParallelConfig()).size == 4
    monkeypatch.setattr(meshlib, "attached_devices", lambda: [torch.device("cuda", 0)])
    assert meshlib.views_mesh(None) is None and meshlib.merge_mesh(None) is None


@pytest.mark.parametrize("n", [1, 2, 8])
def test_reductions_match_numpy(n):
    mesh = meshlib.make_mesh(devices=[CPU] * n)
    rng = np.random.default_rng(n)
    vals = rng.integers(-50, 50, (n, 5)).astype(np.float32)
    shards = [torch.from_numpy(v) for v in vals]
    for fn, ref in ((meshlib.psum, vals.sum(0)), (meshlib.pmax, vals.max(0)),
                    (meshlib.pmin, vals.min(0))):
        out = fn(mesh, shards)
        assert len(out) == n
        for o in out:
            np.testing.assert_array_equal(o.numpy(), ref)
    gathered = meshlib.all_gather(mesh, shards)
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), vals)
    assert meshlib.axis_index(mesh) == list(range(n))


@pytest.mark.parametrize("n", [2, 5])
def test_ppermute_neighbour_pairs_fill_zeros(n):
    mesh = meshlib.make_mesh(devices=[CPU] * n)
    vals = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    shards = [torch.from_numpy(v) for v in vals]
    fwd = meshlib.ppermute(mesh, shards, [(i, i + 1) for i in range(n - 1)])
    bwd = meshlib.ppermute(mesh, shards, [(i + 1, i) for i in range(n - 1)])
    ref_fwd = np.concatenate([np.zeros((1, 3), np.float32), vals[:-1]])
    ref_bwd = np.concatenate([vals[1:], np.zeros((1, 3), np.float32)])
    np.testing.assert_array_equal(torch.stack(fwd).numpy(), ref_fwd)
    np.testing.assert_array_equal(torch.stack(bwd).numpy(), ref_bwd)
    ring = meshlib.ppermute(mesh, shards, [(i, (i + 1) % n) for i in range(n)])
    np.testing.assert_array_equal(torch.stack(ring).numpy(), np.roll(vals, 1, 0))


def test_shardings_split_views_and_rows():
    x = np.arange(4 * 3 * 6 * 5, dtype=np.uint8).reshape(4, 3, 6, 5)
    mesh = meshlib.make_mesh(n_data=2, n_model=3, devices=[CPU] * 6)
    pieces = meshlib.view_sharding(mesh, x)
    assert len(pieces) == 6
    for s, p in enumerate(pieces):
        i, j = divmod(s, 3)
        assert p.is_contiguous()
        np.testing.assert_array_equal(p.numpy(), x[2 * i:2 * i + 2, :, 2 * j:2 * j + 2])
    rows = meshlib.shard_rows(mesh, x[0, 0], axis=0)
    for s, r in enumerate(rows):
        np.testing.assert_array_equal(r.numpy(), x[0, 0, 2 * (s % 3):2 * (s % 3) + 2])
    flat = meshlib.make_mesh(devices=[CPU] * 4)
    batch = meshlib.batch_sharding(flat, x)
    np.testing.assert_array_equal(torch.cat(batch).numpy(), x)
    np.testing.assert_array_equal(meshlib.gather_shards(batch, "cpu").numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.batch_sharding(meshlib.make_mesh(devices=[CPU] * 3), x)
