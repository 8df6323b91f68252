"""The port's device-accumulate merge arm against the JAX package, on the CPU.

Scenes: ``tests/test_device_clouds.py``'s padded views (four views of a
40 mm sphere, 3000 slots, ~30 % valid) for the DeviceClouds handoff, and
``tests/test_registration.py:203``'s three views (0, 15, 30 degrees of a
lumpy object, each seeing the front 70 %) for the registration and the
merge; made with numpy from seeds. The JAX package's device arm runs under
``jax.default_backend`` patched to "tpu" with ``feat_bf16=False`` pinned, as
its own test does; the port's under ``_device_accumulate_ok`` given a CUDA
device (its one gate). Tolerances:

- ``compact_views_device`` / ``stack_views_device`` / ``to_host_list``:
  points, valid, colours and counts bit-equal to the JAX package's;
- ``_preprocess_views`` against ``_preprocess_views_device`` (port): valid
  and valid points bit-equal, features within 1e-5; each against the JAX
  package's: valid bit-equal, voxel means within 1e-4 mm and features within
  1e-4 on >= 99 % of rows (``test_torch_merge.py``'s prep_view bar: the
  port sums voxel means in float64, the JAX package in float32);
- ``_register_chain_batched`` with and without the loop closure, on the JAX
  package's preps with its draws injected: transforms within 1e-4, global
  fitness equal, ICP fitness within 1e-3 (``test_torch_merge.py``'s
  ``register_prep_pairs`` bar);
- ``merge_360``'s device arm against its host-list arm (port): transforms
  within 1e-5 and the merged sets at 1e-3 rounding differing by at most
  max(4, n/200) points; port device arm against the JAX package's device
  arm (JAX preps and draws injected): transforms within 1e-4 and at most
  max(4, n/200) merged points of either without a point of the other within
  1e-3 mm (rounding both sets at 1e-3 is no bar across the packages: their
  float32 and float64 voxel sums differ by an ulp, which flips the rounding
  of ~1 % of coordinates);
- a DeviceClouds stack on the CPU: the gate refuses it, and the merge equals
  the host list's byte for byte;
- ``feat_bf16=True`` through the whole merge: the JAX package's merge bar
  (chamfer to view 0 under 4 mm).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu.utils import synthetic as jsyn
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec

QUIET = dict(log=lambda *a: None)
MERGE_KW = dict(voxel_size=2.0, ransac_trials=1024, icp_iters=15, final_voxel=1.0,
                outlier_nb=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors beside the other test workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded_views(rng, n_views=4, slots=3000, valid_frac=0.3):
    """tests/test_device_clouds.py's scene."""
    pts = np.full((n_views, slots, 3), 1e9, np.float32)
    cols = np.zeros((n_views, slots, 3), np.uint8)
    valid = np.zeros((n_views, slots), bool)
    host = []
    for i in range(n_views):
        n = int(slots * valid_frac) + rng.integers(0, 200)
        sel = np.sort(rng.choice(slots, n, replace=False))
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        p = (40.0 * u + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
        th = np.deg2rad(12.0 * i)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]], np.float32)
        p = (p @ R.T).astype(np.float32)
        c = rng.integers(0, 255, (n, 3)).astype(np.uint8)
        pts[i, sel] = p
        cols[i, sel] = c
        valid[i, sel] = True
        host.append((p, c))
    return pts, valid, cols, host


def _rand_cloud(rng, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * d[:, 0]) * np.cos(3 * d[:, 1]))
    return (d * r[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def chain_views():
    """tests/test_registration.py:203's three views."""
    rng = np.random.default_rng(0)
    base = _rand_cloud(rng, 6000)
    out = []
    for ang in (0, 15, 30):
        world = base @ np.asarray(jsyn.rotate_y(ang), np.float32).T
        vis = world[:, 2] < np.percentile(world[:, 2], 70)
        out.append((world[vis].astype(np.float32),
                    np.full((int(vis.sum()), 3), 128, np.uint8)))
    return out


def _on_card(monkeypatch):
    """The port's gate as it reads on the card: the same checks, a CUDA device."""
    real = rec._device_accumulate_ok
    monkeypatch.setattr(rec, "_device_accumulate_ok",
                        lambda cfg, cb, n, s, a, dev, why=None:
                        real(cfg, cb, n, s, a, torch.device("cuda"), why))


def _jax_draws(preps, loop_closure, trials):
    """The JAX package's RANSAC draws of ``_register_chain_batched``: pair i
    of the batch at key fold_in(PRNGKey(0), i), over the shared bucket."""
    srcs = preps[1:] + ([preps[-1]] if loop_closure else [])
    dsts = preps[:-1] + ([preps[0]] if loop_closure else [])
    out = []
    for i, (s, d) in enumerate(zip(srcs, dsts)):
        _, ok = jreg._feature_correspondences(s.features, d.features, s.valid, d.valid, True)
        p = ok.astype(jnp.float32) / jnp.maximum(ok.sum(), 1)
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        out.append(np.asarray(jax.random.choice(key, s.points.shape[0], (trials, 3), p=p)))
    return out


def _port_preps(jpreps):
    return [rec.prep_from_reference(p, "cpu") for p in jpreps]


def test_compact_and_stack_views_device_match_jax():
    pts, valid, cols, host = _padded_views(np.random.default_rng(7))
    for dc, jdc in ((rec.compact_views_device(pts, valid, cols, device="cpu"),
                     jrec.compact_views_device(pts, valid, cols)),
                    (rec.stack_views_device(host, device="cpu"),
                     jrec.stack_views_device(host))):
        np.testing.assert_array_equal(dc.points.numpy(), np.asarray(jdc.points))
        np.testing.assert_array_equal(dc.valid.numpy(), np.asarray(jdc.valid))
        np.testing.assert_array_equal(dc.colors.numpy(), np.asarray(jdc.colors))
        np.testing.assert_array_equal(dc.counts, jdc.counts)
        for (p, c), (ph, ch) in zip(dc.to_host_list(), host):
            np.testing.assert_array_equal(p, ph)
            np.testing.assert_array_equal(c, ch)
    # device tensors stay where they are, padded in place; a gray channel
    # becomes three
    dc = rec.stack_views_device([(torch.from_numpy(p), torch.from_numpy(c))
                                 for p, c in host])
    np.testing.assert_array_equal(dc.points.numpy(), np.asarray(jrec.stack_views_device(
        host).points))
    gray = rec.compact_views_device(torch.from_numpy(pts), torch.from_numpy(valid),
                                    torch.from_numpy(cols[..., :1]))
    assert gray.colors.shape[-1] == 3
    np.testing.assert_array_equal(gray.colors[..., 2].numpy(), gray.colors[..., 0].numpy())
    back = rec.device_clouds_from_reference(jrec.compact_views_device(pts, valid, cols),
                                            "cpu")
    np.testing.assert_array_equal(back.points.numpy(), rec.compact_views_device(
        pts, valid, cols, device="cpu").points.numpy())


def test_preprocess_views_host_and_device_match_each_other_and_jax():
    pts, valid, cols, host = _padded_views(np.random.default_rng(10))
    dc = rec.compact_views_device(pts, valid, cols, device="cpu")
    preps_h = rec._preprocess_views(host, 3.0, 0, device="cpu")
    preps_d, raw = rec._preprocess_views_device(dc, 3.0)
    assert raw[0] is dc.points and len(preps_h) == len(preps_d) == 4
    jpreps = jrec._preprocess_views(host, 3.0, 0)
    for a, b, j in zip(preps_h, preps_d, jpreps):
        v = a.valid.numpy()
        assert a.points.shape == j.points.shape and a.points.shape[0] % 2048 == 0
        np.testing.assert_array_equal(v, b.valid.numpy())
        np.testing.assert_array_equal(a.points.numpy()[v], b.points.numpy()[v])
        np.testing.assert_allclose(a.features.numpy()[v], b.features.numpy()[v], atol=1e-5)
        np.testing.assert_array_equal(v, np.asarray(j.valid))
        np.testing.assert_allclose(a.points.numpy()[v], np.asarray(j.points)[v], atol=1e-4)
        close = np.abs(a.features.numpy() - np.asarray(j.features)).max(axis=1)[v] <= 1e-4
        assert close.mean() >= 0.99


@pytest.mark.parametrize("loop_closure", [False, True])
def test_register_chain_batched_with_the_reference_draws(chain_views, loop_closure):
    cfg = jconfig.MergeConfig(**MERGE_KW)
    jpreps = jrec._preprocess_views(chain_views, 2.0, 0)
    T_j, gf_j, fi_j, _ = jrec._register_chain_batched(jpreps, cfg, 2.0, loop_closure,
                                                      feat_bf16=False)
    T, gf, fi, _ = rec._register_chain_batched(
        _port_preps(jpreps), config.MergeConfig(**MERGE_KW), 2.0, loop_closure,
        samples=_jax_draws(jpreps, loop_closure, cfg.ransac_trials))
    assert T.shape == (3 if loop_closure else 2, 4, 4)
    np.testing.assert_allclose(T, T_j, atol=1e-4)
    np.testing.assert_array_equal(gf, gf_j)
    np.testing.assert_allclose(fi, fi_j, atol=1e-3)
    assert (fi > 0.8).all()


def _rounded(points):
    return {tuple(np.round(r, 3)) for r in np.asarray(points)}


def test_merge_360_device_arm_against_host_list_and_jax(chain_views, monkeypatch):
    cfg = config.MergeConfig(**MERGE_KW)
    tm_h = {}
    p_h, c_h, T_h = rec.merge_360(chain_views, cfg, device="cpu", timings=tm_h, **QUIET)
    assert tm_h["arm"] == "host-list" and "not an accelerator" in tm_h["refused"]

    jcfg = jconfig.MergeConfig(**MERGE_KW)
    jpreps = jrec._preprocess_views(chain_views, 2.0, 0)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    p_j, _, T_j = jrec.merge_360(chain_views, jcfg, feat_bf16=False, **QUIET)
    monkeypatch.undo()

    _on_card(monkeypatch)
    calls = []
    real_acc = rec._accumulate_views
    monkeypatch.setattr(rec, "_accumulate_views",
                        lambda *a: (calls.append(1), real_acc(*a))[1])
    tm = {}
    p_d, c_d, T_d = rec.merge_360(chain_views, cfg, device="cpu", timings=tm, **QUIET)
    assert calls and tm["arm"] == "device" and len(p_d) == len(c_d)
    assert set(tm) >= {"preprocess_s", "register_s", "accumulate_s", "postprocess_s"}
    np.testing.assert_allclose(np.stack(T_d), np.stack(T_h), atol=1e-5)
    hs, ds = _rounded(p_h), _rounded(p_d)
    assert len(hs ^ ds) <= max(4, len(hs) // 200), (len(hs), len(ds), len(hs ^ ds))

    # on the JAX package's preps and draws: its device arm's transforms and set
    real_pre, real_reg = rec._preprocess_views, rec._register_chain_batched
    monkeypatch.setattr(rec, "_preprocess_views", lambda *a, **k: (
        _port_preps(jpreps), real_pre(*a, **k)[1]))
    monkeypatch.setattr(rec, "_register_chain_batched", functools.partial(
        real_reg, samples=_jax_draws(jpreps, False, jcfg.ransac_trials)))
    p_x, _, T_x = rec.merge_360(chain_views, cfg, device="cpu", **QUIET)
    np.testing.assert_allclose(np.stack(T_x), np.stack(T_j), atol=1e-4)
    from scipy.spatial import cKDTree

    p_j = np.asarray(p_j)
    far = (int((cKDTree(p_j).query(p_x)[0] > 1e-3).sum())
           + int((cKDTree(p_x).query(p_j)[0] > 1e-3).sum()))
    assert far <= max(4, len(p_j) // 200), (len(p_j), len(p_x), far)


def test_the_gate_refuses_what_the_jax_package_refuses():
    cfg = config.MergeConfig()
    cuda = torch.device("cuda")
    assert rec._device_accumulate_ok(cfg, None, 24, 40960, 24 * 30000, cuda)
    for args, reason in (
            ((cfg, None, 24, 40960, 24 * 30000, torch.device("cpu")), "accelerator"),
            ((cfg, print, 24, 40960, 24 * 30000, cuda), "step callback"),
            ((config.MergeConfig(sample_before=2), None, 24, 40960, 24 * 30000, cuda),
             "sample_before"),
            ((config.MergeConfig(outlier_nb=0), None, 24, 40960, 24 * 30000, cuda),
             "postprocess"),
            ((cfg, None, 24, 8 << 20, 24 * (8 << 20), cuda), "1 GiB"),
            ((cfg, None, 24, 40960, 24 * 10000, cuda), "occupancy")):
        why = []
        assert not rec._device_accumulate_ok(*args, why=why)
        assert reason in why[0], why


def test_merge_360_device_clouds_on_the_cpu_equal_the_host_list():
    pts, valid, cols, host = _padded_views(np.random.default_rng(9))
    dc = rec.compact_views_device(pts, valid, cols, device="cpu")
    cfg = config.MergeConfig(ransac_trials=256, icp_iters=5)
    tm = {}
    p1, c1, T1 = rec.merge_360(host, cfg, device="cpu", **QUIET)
    p2, c2, T2 = rec.merge_360(dc, cfg, timings=tm, **QUIET)
    assert tm["arm"] == "host-list"
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(np.stack(T1), np.stack(T2))


def test_merge_360_with_bf16_features_still_aligns(chain_views):
    """feat_bf16=True through the whole merge (the bf16-rounded feature
    product; on the CPU its inputs widened to f32): the chain still lands
    on view 0's surface, the JAX package's merge bar
    (tests/test_registration.py:148: chamfer under 4 mm)."""
    cfg = config.MergeConfig(**MERGE_KW)
    p, c, T = rec.merge_360(chain_views, cfg, device="cpu", feat_bf16=True, **QUIET)
    assert len(T) == 3 and len(p) == len(c) > 1000
    assert rec.chamfer_distance(p[:20000], chain_views[0][0], device="cpu") < 4.0
