"""The rest of the JAX package's public API in the port, on the CPU: the same
seeded numpy inputs through the JAX function and its port counterpart.

- host twins (``otsu_threshold_np``, ``decode_packed_np``, ``pad_points``,
  ``knn_np`` / ``radius_count_np`` with and without ``exclude_self``,
  ``voxel_downsample_np``), ``load_stack(expected=)`` and its error,
  ``is_packed_source`` and ``PackedStack.nbytes``: equal;
  ``decode_packed_np`` also bit-equal to ``decode_stack_np`` on the raw
  stack; ``estimate_normals_np``: |n . n_ref| >= 1 - 1e-5 on every row;
- ``write_mesh_ply`` with colours and normals and
  ``MetricsRegistry.to_prometheus``: equal bytes and text;
- ``WritebackQueue.drain``: two injected ``ply.write`` faults, and a write
  stalled past ``drain(timeout_s)``, raise one ``PlyWriteError`` with the
  same paths and error types in both packages;
- ``StageTimer``: the same records, ``as_dict`` keys and ``report`` layout;
  ``attach_callback`` keeps one handler a callback, ``attached_callback``
  detaches on an exception; ``watchdog_resume`` re-arms breach detection
  as the JAX package's does;
- ``preprocess_for_registration``: against the JAX package's at
  ``test_torch_merge.py::test_prep_view_matches_jax``'s bars (same bucket
  and valid prefix, points within 1e-4 mm, normals |dot| >= 1 - 1e-4 and
  features within 1e-4 on >= 99 % of rows), and equal to the port's
  ``prep_view`` of the same points bit for bit on the valid rows; the
  ``pad_to`` ValueError with the JAX message;
- ``register_prep_pairs(batch=)``: equal transforms at batch 1 and 4;
- ``forward_async`` / ``forward_views_batched``: the bytes of ``forward`` /
  ``forward_views``, and against the JAX scanner at
  ``tests/test_torch_scanner.py``'s tolerances (valid equal, points within
  1e-3 mm); a mesh that does not divide V raises the JAX ``ValueError``;
- the serial reconstruct lane's ``StageTimer`` report and the batched
  lane's overlap line reach the framework log at DEBUG;
- ``sl3d pipeline --view-plys --no-incremental``: the same configuration in
  both packages' ``pipeline`` commands, the run stubbed.
"""
import logging
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import cli as jcli
from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.models import reconstruction as jrec
from structured_light_for_3d_model_replication_tpu.models.scanner import (
    SLScanner as JaxScanner,
)
from structured_light_for_3d_model_replication_tpu.ops import graycode as jgc
from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import normals as jnormals
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.utils import deadline as jdl
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu.utils import profiling as jprof
from structured_light_for_3d_model_replication_tpu.utils import telemetry as jtel
from structured_light_for_3d_model_replication_tpu_torch import cli, config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.models import reconstruction as rec
from structured_light_for_3d_model_replication_tpu_torch.models import scanner as sm
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn
from structured_light_for_3d_model_replication_tpu_torch.ops import normals
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import profiling as prof
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn
from structured_light_for_3d_model_replication_tpu_torch.utils import telemetry as tel

CAM = PROJ = (256, 64)
MANUAL = dict(thresh_mode="manual", shadow_val=40.0, contrast_val=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def scene():
    rig = syn.default_rig(cam_size=CAM, proj_size=PROJ)
    frames, _ = syn.render_scene(rig, syn.sphere_on_background())
    views = []
    for v in range(2):
        noise = np.random.default_rng(100 + v).integers(-8, 9, frames.shape)
        views.append(np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return rig, np.stack(views)


@pytest.fixture(scope="module")
def cloud():
    """A lumpy closed surface (tests/test_torch_merge.py's), 0.05 mm noise,
    with 400 invalid rows at random places."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 50 * (1 + 0.25 * np.sin(4 * d[:, 0]) * np.cos(3 * d[:, 1]))
    pts = (d * r[:, None] + rng.normal(0, 0.05, (4000, 3))).astype(np.float32)
    valid = np.ones(4000, bool)
    valid[rng.choice(4000, 400, replace=False)] = False
    pts[~valid] = rng.uniform(-500, 500, (400, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (4000, 3), dtype=np.uint8)
    return pts, cols, valid


# ---------------------------------------------------------------------------
# host twins
# ---------------------------------------------------------------------------

def test_otsu_threshold_np_matches_jax():
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (48, 64), dtype=np.uint8),
                np.concatenate([rng.integers(10, 60, 500), rng.integers(150, 240, 700)]
                               ).astype(np.uint8).reshape(30, 40),
                np.full((8, 8), 7, np.uint8)):
        assert gc.otsu_threshold_np(img) == jgc.otsu_threshold_np(img)


@pytest.mark.parametrize("case", ["otsu", "manual", "truncated", "downsample"])
def test_decode_packed_np_matches_jax_and_the_raw_decode(case):
    n_cols, n_rows, ds = 64, 32, 2 if case == "downsample" else 1
    base = gc.generate_pattern_stack(n_cols, n_rows, downsample=ds)
    noise = np.random.default_rng(3).integers(-20, 21, base.shape)
    frames = np.clip(base.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    kw = dict(n_cols=n_cols, n_rows=n_rows, n_sets_col=5, n_sets_row=4, downsample=ds,
              thresh_mode="manual" if case == "manual" else "otsu")
    if case == "truncated":
        frames = frames[:12]
        kw["skip_remaining_before_row"] = True
    ps = imio.pack_stack(frames)
    got = gc.decode_packed_np(ps.planes, ps.white, ps.black, n_frames=ps.n_frames, **kw)
    ref = jgc.decode_packed_np(ps.planes, ps.white, ps.black, n_frames=ps.n_frames, **kw)
    raw = gc.decode_stack_np(frames, **kw)
    for a, b, c in zip(got, ref, raw):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got.mask.sum() > 100


def test_pad_points_matches_jax():
    pts = np.random.default_rng(4).normal(size=(37, 3)).astype(np.float32)
    for valid in (None, np.arange(37) % 3 > 0):
        for multiple in (8, 37, 64):
            for a, b in zip(knn.pad_points(pts, valid, multiple),
                            jknn.pad_points(pts, valid, multiple)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_knn_np_and_radius_count_np_match_jax(cloud, exclude_self):
    pts, _, valid = cloud
    for k, p, v in ((8, pts, valid), (5, pts[:4], valid[:4])):   # and fewer rows than k
        for a, b in zip(knn.knn_np(p, v, k, exclude_self=exclude_self),
                        jknn.knn_np(p, v, k, exclude_self=exclude_self)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        knn.radius_count_np(pts, valid, 4.0, exclude_self=exclude_self),
        jknn.radius_count_np(pts, valid, 4.0, exclude_self=exclude_self))


def test_voxel_downsample_np_matches_jax(cloud):
    pts, cols, valid = cloud
    for c in (cols, None):
        for a, b in zip(pc.voxel_downsample_np(pts, c, valid, 3.0),
                        jpc.voxel_downsample_np(pts, c, valid, 3.0)):
            np.testing.assert_array_equal(a, b)


def test_estimate_normals_np_matches_jax(cloud):
    pts, _, valid = cloud
    for radius in (None, 6.0):
        got = normals.estimate_normals_np(pts[:800], valid[:800], k=12, radius=radius)
        ref = jnormals.estimate_normals_np(pts[:800], valid[:800], k=12, radius=radius)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert (np.abs((got * ref).sum(-1)) >= 1 - 1e-5).all()


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_load_stack_expected_packed_source_and_nbytes(tmp_path):
    frames = np.random.default_rng(5).integers(0, 256, (6, 8, 12), dtype=np.uint8)
    raw = str(tmp_path / "raw")
    jimio.save_stack(raw, frames)
    packed = str(tmp_path / "packed")
    imio.save_packed_stack(packed, imio.pack_stack(frames))
    for src in (raw, packed):
        for a, b in zip(imio.load_stack(src, expected=6), jimio.load_stack(src, expected=6)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError) as port_err:
            imio.load_stack(src, expected=7)
        with pytest.raises(ValueError) as jax_err:
            jimio.load_stack(src, expected=7)
        assert str(port_err.value) == str(jax_err.value)
        assert imio.is_packed_source(src) == jimio.is_packed_source(src) == (src == packed)
    assert imio.load_stack(raw)[0].shape == (6, 8, 12)
    ps, jps = imio.pack_stack(frames), jimio.pack_stack(frames)
    assert ps.nbytes == jps.nbytes == 3 * 8 * 12


def test_write_mesh_ply_with_colours_and_normals_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (30, 3)).astype(np.int32)
    c = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    n = rng.normal(size=(50, 3)).astype(np.float32)
    for kw in ({}, {"colors": c}, {"normals": n}, {"colors": c, "normals": n}):
        ply.write_mesh_ply(str(tmp_path / "a.ply"), v, f, **kw)
        jply.write_mesh_ply(str(tmp_path / "b.ply"), v, f, **kw)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def test_to_prometheus_equals_jax():
    regs = (tel.MetricsRegistry(), jtel.MetricsRegistry())
    for reg in regs:
        reg.inc("sl3d_views_total", 3, tenant="a")
        reg.inc("sl3d_views_total", tenant='b"x')
        reg.set_gauge("sl3d_degraded", 1)
        for v in (0.01, 0.2, 3.0, 40.0):
            reg.observe("sl3d_view_seconds", v, stage="compute")
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert "# TYPE sl3d_view_seconds histogram" in regs[0].to_prometheus()


def _drain_errors(plymod, faultmod, tmp_path, spec, timeout_s):
    faultmod.configure(spec)
    q = plymod.WritebackQueue()
    pts = np.zeros((4, 3), np.float32)
    q.submit(str(tmp_path / "w0.ply"), pts).result()   # settled before the budget starts
    for i in (1, 2, 3):
        q.submit(str(tmp_path / f"w{i}.ply"), pts)
    with pytest.raises(plymod.PlyWriteError) as err:
        q.drain(timeout_s=timeout_s)
    assert q.backlog == 0                     # drain forgets what it reported
    q.close(wait=True)                        # the stalled writer ends before the dir goes
    faultmod.reset()
    return ([(os.path.basename(p), type(e).__name__) for p, e in err.value.errors],
            str(err.value).split(":")[0])


@pytest.mark.parametrize("arm", ["faults", "stalled"])
def test_drain_raises_one_ply_write_error_like_jax(tmp_path, arm):
    if arm == "faults":
        spec, timeout_s = "ply.write~w1.ply:permanent,ply.write~w3.ply:permanent", None
    else:
        # w1 stalls past the budget; w2 and w3 queue behind it on the one writer
        spec, timeout_s = "ply.write~w1.ply:stall(0.5)", 0.2
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _drain_errors(ply, faults, tmp_path / "port", spec, timeout_s)
    ref = _drain_errors(jply, jfaults, tmp_path / "jax", spec, timeout_s)
    assert got == ref
    if arm == "faults":
        assert got[0] == [("w1.ply", "PermanentFault"), ("w3.ply", "PermanentFault")]
        assert got[1] == "2 PLY write(s) failed"
        assert (tmp_path / "port" / "w2.ply").exists()
    else:
        assert got[0] == [(f"w{i}.ply", "DeadlineExceeded") for i in (1, 2, 3)]


# ---------------------------------------------------------------------------
# the logger, StageTimer, the watchdog
# ---------------------------------------------------------------------------

def _timed(mod):
    timer = mod.StageTimer()
    with timer.stage("view_000"):
        with timer.stage("load"):
            pass
        with timer.stage("compute"):
            pass
    with timer.stage("view_001"):
        pass
    with timer.stage("load"):
        pass
    return timer


def test_stage_timer_matches_jax():
    got, ref = _timed(prof), _timed(jprof)
    assert [(r.name, r.depth) for r in got.records] == [(r.name, r.depth) for r in ref.records]
    assert list(got.as_dict()) == list(ref.as_dict())
    assert got.total("load") == sum(r.elapsed_s for r in got.records if r.name == "load")

    def layout(t):
        return re.sub(r"\d+\.\d{3}s", "Ts", t.report())

    assert layout(got) == layout(ref)
    assert layout(got).splitlines()[0] == "  load" + " " * 28 + " " * 5 + "Ts"
    lines = []
    with prof.StageTimer().stage("x", log=lines.append):
        pass
    assert re.fullmatch(r"\[timing\] x: \d+\.\d{3}s", lines[0])


@pytest.mark.parametrize("mod", [prof, jprof], ids=["port", "jax"])
def test_attach_callback_one_handler_and_scoped_detach(mod):
    logger = mod.get_logger()
    assert logger is logging.getLogger("sl3d")
    seen: list[str] = []

    class Sink:
        def log(self, msg):
            seen.append(msg)

    sink = Sink()

    def ours():
        return [h for h in logger.handlers if isinstance(h, mod._CallbackHandler)]

    before = len(ours())
    h1 = mod.attach_callback(sink.log)
    h2 = mod.attach_callback(sink.log)     # an equal bound method: replaces h1
    assert len(ours()) == before + 1 and h1 not in logger.handlers
    logger.warning("once")
    assert seen == ["once"]
    mod.detach_callback(h2)
    assert len(ours()) == before
    with pytest.raises(KeyError):
        with mod.attached_callback(seen.append) as h:
            assert h in logger.handlers
            raise KeyError("out")
    assert h not in logger.handlers and len(ours()) == before


def _watchdog_run(mod):
    """Breaches seen at each step: stall, poll again, suspend + resume, a
    second stall."""
    wd = mod.Watchdog(soft_stall_s=0.2, hard_stall_s=0, token=mod.CancelToken(), poll_s=60)
    prev = mod.activate(mod.RunContext(watchdog=wd))
    try:
        steps = []
        time.sleep(0.3)
        wd._poll()
        steps.append(len(wd.breaches))
        wd._poll()                          # one breach an episode
        steps.append(len(wd.breaches))
        mod.watchdog_suspend()
        time.sleep(0.3)
        wd._poll()                          # suspended: no breach
        steps.append(len(wd.breaches))
        mod.watchdog_resume()
        wd._poll()                          # the age clock restarted
        steps.append(len(wd.breaches))
        time.sleep(0.3)
        wd._poll()                          # re-armed: the next stall fires
        steps.append(len(wd.breaches))
    finally:
        mod.deactivate(prev)
    return steps, [b["level"] for b in wd.breaches]


def test_watchdog_resume_rearms_like_jax():
    got = _watchdog_run(dl)
    assert got == _watchdog_run(jdl)
    assert got == ([1, 1, 1, 1, 2], ["soft", "soft"])
    assert "watchdog_resume" in dl.__all__
    dl.watchdog_resume()   # no ambient watchdog: a no-op


# ---------------------------------------------------------------------------
# registration prep
# ---------------------------------------------------------------------------

def test_preprocess_for_registration_matches_jax_and_prep_view(cloud):
    pts, cols, valid = cloud
    jp = jrec.preprocess_for_registration(pts, cols, valid, 2.0)
    tp = rec.preprocess_for_registration(pts, cols, valid, 2.0, device="cpu")
    assert tp.points.shape == jp.points.shape and tp.points.shape[0] % 2048 == 0
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), v)
    np.testing.assert_allclose(tp.points.numpy()[v], np.asarray(jp.points)[v], atol=1e-4)
    np.testing.assert_array_equal(tp.points.numpy()[~v], np.asarray(jp.points)[~v])
    dots = np.abs((tp.normals.numpy() * np.asarray(jp.normals)).sum(-1))[v]
    assert (dots >= 1 - 1e-4).mean() >= 0.99
    close = np.abs(tp.features.numpy() - np.asarray(jp.features)).max(axis=1)[v] <= 1e-4
    assert close.mean() >= 0.99
    # the port's prep_view of the same (valid) points, bit for bit
    alone = rec.prep_view(pts[valid], 2.0, device="cpu")
    n = int(v.sum())
    assert alone.points.shape == tp.points.shape
    for a, b in ((alone.points, tp.points), (alone.normals, tp.normals),
                 (alone.features, tp.features)):
        assert torch.equal(a[:n], b[:n])
    # a larger pad_to keeps the valid rows; a smaller one raises as the JAX package
    big = rec.preprocess_for_registration(torch.from_numpy(pts), None,
                                          torch.from_numpy(valid), 2.0, pad_to=4096,
                                          device="cpu")
    assert big.points.shape[0] == 4096 and torch.equal(big.features[:n], tp.features[:n])
    with pytest.raises(ValueError) as port_err:
        rec.preprocess_for_registration(pts, cols, valid, 2.0, pad_to=16, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jrec.preprocess_for_registration(pts, cols, valid, 2.0, pad_to=16)
    assert str(port_err.value) == str(jax_err.value)


def test_register_prep_pairs_batch_override(cloud):
    """``batch`` overrides ``merge.pair_batch``: the pairs registered one a
    group and four a group give the same transforms and fitnesses."""
    pts, _, valid = cloud
    base = pts[valid][::3]
    rng = np.random.default_rng(7)
    views = []
    for ang in (0.0, 8.0, 16.0):
        a = np.radians(ang)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        views.append(base @ R.T + rng.normal(0, 0.05, base.shape).astype(np.float32))
    preps = [rec.prep_view(p, 4.0, device="cpu") for p in views]
    pairs = [(preps[i], preps[i - 1]) for i in (1, 2)]
    cfg = config.MergeConfig(voxel_size=4.0, ransac_trials=128, icp_iters=4, pair_batch=1)
    one = rec.register_prep_pairs(pairs, [0, 1], cfg, 4.0)
    four = rec.register_prep_pairs(pairs, [0, 1], cfg, 4.0, batch=4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
    assert (one[2] > 0.5).all()


# ---------------------------------------------------------------------------
# the scanner
# ---------------------------------------------------------------------------

def _assert_close_to_jax(port, ref):
    v_port, v_ref = port.valid.numpy(), np.asarray(ref.valid)
    np.testing.assert_array_equal(v_port, v_ref)
    assert v_port.sum() > 1000
    assert np.abs(port.points.numpy()[v_port] - np.asarray(ref.points)[v_ref]).max() <= 1e-3
    np.testing.assert_array_equal(port.colors.numpy(), np.asarray(ref.colors))


@pytest.mark.parametrize("plane_eval", ["table", "quadratic"])
def test_forward_async_and_forward_views_batched(scene, plane_eval):
    rig, frames_v = scene
    calib = rig.calibration()
    port = sm.SLScanner(calib, CAM, PROJ, plane_eval=plane_eval, device="cpu")
    kernels.reset_launch_counts()
    whole = port.forward_views(frames_v, **MANUAL)
    batched = port.forward_views_batched(frames_v, **MANUAL)
    one = port.forward(frames_v[0], **MANUAL)
    async_np = port.forward_async(frames_v[0], **MANUAL)
    async_t = port.forward_async(torch.from_numpy(frames_v[0]), **MANUAL)
    assert not any(kernels.launch_counts().values())   # CPU tensors: plain versions
    for a, b in zip(batched, whole):
        assert torch.equal(a, b)
    for out in (async_np, async_t):
        for a, b in zip(out, one):
            assert torch.equal(a, b)
    if plane_eval == "table":
        ref = JaxScanner(calib, CAM, PROJ, plane_eval=plane_eval)
        _assert_close_to_jax(batched, ref.forward_views_batched(jnp.asarray(frames_v),
                                                                **MANUAL))
        _assert_close_to_jax(async_np, ref.forward_async(frames_v[0], **MANUAL))


def test_forward_views_batched_mesh_refusal_matches_jax(scene):
    rig, frames_v = scene
    calib = rig.calibration()
    port = sm.SLScanner(calib, CAM, PROJ, device="cpu")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError) as port_err:
        port.forward_views_batched(frames_v, mesh=meshlib.make_mesh(
            devices=[torch.device("cpu")] * 3), **MANUAL)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:3]), ("data",))
    with pytest.raises(ValueError) as jax_err:
        JaxScanner(calib, CAM, PROJ).forward_views_batched(jnp.asarray(frames_v), mesh=jmesh,
                                                           **MANUAL)
    assert str(port_err.value) == str(jax_err.value)
    sharded = port.forward_views_batched(frames_v, mesh=meshlib.make_mesh(
        devices=[torch.device("cpu")] * 2), **MANUAL)
    for a, b in zip(sharded, port.forward_views(frames_v, **MANUAL)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the lanes' DEBUG reports, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("api_ds")
    rig, scene_, poses = syn.pipeline_scene(cam_size=(160, 120), proj_size=(128, 64),
                                            n_views=2, step_deg=15.0)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene_.transformed(R, t))
        imio.save_packed_stack(str(root / "scans" / f"view_{i * 15:03d}deg"),
                               imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root


@pytest.mark.parametrize("lane,over,want", [
    ("serial", {"parallel.compute_batch": 1, "parallel.io_workers": 1},
     "reconstruct stage timing:\n"),
    ("batched", {"parallel.compute_batch": 2, "parallel.io_workers": 2},
     "reconstruct batched overlap: load ")])
def test_lane_reports_reach_the_debug_log(dataset, tmp_path, lane, over, want):
    cfg = config.load_config(None, {"decode.n_cols": "128", "decode.n_rows": "64",
                                    "decode.thresh_mode": "manual", **over})
    logger = prof.get_logger()
    level = logger.level
    logger.setLevel(logging.DEBUG)
    msgs: list[str] = []
    try:
        with prof.attached_callback(msgs.append, level=logging.DEBUG):
            report = stages.reconstruct(str(dataset / "calib.npz"), str(dataset / "scans"),
                                        mode="batch", output=str(tmp_path), cfg=cfg,
                                        device="cpu", log=lambda m: None)
    finally:
        logger.setLevel(level)
    assert report.lane == lane and len(report.outputs) == 2
    hits = [m for m in msgs if m.startswith(want)]
    assert len(hits) == 1, msgs
    if lane == "serial":
        assert [ln.split()[0] for ln in hits[0].splitlines()[1:]] == [
            "view_000deg", "view_015deg"]


class _Stop(Exception):
    def __init__(self, cfg):
        super().__init__("stubbed run")
        self.cfg = cfg


def test_pipeline_view_plys_and_incremental_flags_set_the_jax_config(monkeypatch):
    def stub(calib, target, out, cfg=None, **kw):
        raise _Stop(cfg)

    monkeypatch.setattr(stages, "run_pipeline", stub)
    monkeypatch.setattr(jstages, "run_pipeline", stub)
    for flags, want in ((["--view-plys", "--no-incremental"], (True, False)),
                        (["--incremental"], (False, True)), ([], (False, False))):
        argv = ["pipeline", "scans", "--calib", "c.mat", "--out", "out", *flags]
        with pytest.raises(_Stop) as port_run:
            cli.main(argv)
        with pytest.raises(_Stop) as jax_run:
            jcli.main(argv)
        port_cfg, jax_cfg = port_run.value.cfg, jax_run.value.cfg
        assert (port_cfg.pipeline.write_view_plys, port_cfg.merge.incremental) == want
        assert config.jax_dict(port_cfg) == jax_cfg.to_dict()
