"""The port's reconstruct executor on the CPU: the serial, pipelined and
batched lanes against each other and against the JAX package's.

Five views of the pipeline scene (``synthetic.pipeline_scene``, a 160x120
camera, a 128x64 projector) are stored twice: as PNG frame folders (raw
sources) and as .slbp containers (packed sources). At compute_batch 3 the
batched lane has a full batch and a ragged tail of 2. Tolerances:

- within the port, byte for byte: every lane (serial: io_workers 1; the
  pipelined per-view lane: compute_batch 1, io_workers 2; batched and
  packed: compute_batch 3, prefetch_depth 1) writes the same PLYs with the
  same ``outputs`` and ``failed``, on both sources; the same holds under a
  permanent load failure of the second view and a permanent
  ``compute.view`` fault of the fourth (the JAX package's
  tests/test_pipeline_executor.py:117-168);
- against the JAX package: the port's batched lane against the JAX
  package's ``_reconstruct_batched`` (compute_batch 3) on the PNG sources,
  the same point counts and colours, coordinates within 1e-3 mm plus 1e-6
  of their size (the scene's floor reaches 11 m from the camera, where one
  f32 step is 1e-3 mm and the two packages' f32 ray-plane hits differ by up
  to 5 steps); the ASCII
  ``write_ply`` equal to the JAX writer's byte for byte;
- small parts: the writeback queue keeps order, re-raises and retries a
  transient; ``prefetch_depth``, ``fused_clean`` and ``ascii_output`` load,
  override and are not logged as dropped; no schedule knob changes a view
  cache key; the CLI flags carry the JAX package's names; no lane thread
  outlives a run; a pinned staging slot never has two holders.
"""
import os
import threading

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu_torch import cli, config
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import matfile, ply
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.utils import faults
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn

VIEWS = 5
STEP_DEG = 15.0
DECODE = {"decode.n_cols": "128", "decode.n_rows": "64", "decode.thresh_mode": "manual"}
LANES = {"serial": {"parallel.compute_batch": 1, "parallel.io_workers": 1},
         "pipelined": {"parallel.compute_batch": 1, "parallel.io_workers": 2},
         "batched": {"parallel.compute_batch": 3, "parallel.io_workers": 2,
                     "parallel.prefetch_depth": 1},
         "packed": {"parallel.compute_batch": 3, "parallel.io_workers": 2,
                    "parallel.prefetch_depth": 1, "pipeline.packed_ingest": True}}
LANE_THREADS = ("sl3d-prefetch", "sl3d-drain", "sl3d-plywrite")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors beside the other test workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.reset()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("executor_ds")
    rig, scene, poses = syn.pipeline_scene(cam_size=(160, 120), proj_size=(128, 64),
                                           n_views=VIEWS, step_deg=STEP_DEG)
    for i, (R, t) in enumerate(poses):
        frames, _ = syn.render_scene(rig, scene.transformed(R, t))
        name = f"view_{round(i * STEP_DEG):03d}deg"
        jimio.save_stack(str(root / "png" / name), frames)
        imio.save_packed_stack(str(root / "slbp" / name), imio.pack_stack(frames))
    matfile.save_calibration(str(root / "calib.npz"), rig.calibration())
    return root


def _run(root, source, out, **over):
    cfg = config.load_config(None, {**DECODE, **over})
    return stages.reconstruct(str(root / "calib.npz"), str(root / source), mode="batch",
                              output=str(out), cfg=cfg, device="cpu", log=lambda m: None)


def _report_key(rep):
    return ([os.path.basename(p) for p in rep.outputs], rep.points,
            [(os.path.basename(s), msg) for s, msg in rep.failed],
            [(f.view, f.stage, f.error_type) for f in rep.failures])


@pytest.fixture(scope="module")
def lanes(dataset, tmp_path_factory):
    """Every lane on both sources: {(source, lane): (report, out dir)}."""
    out = {}
    for source in ("png", "slbp"):
        for lane, over in LANES.items():
            d = tmp_path_factory.mktemp(f"{source}_{lane}")
            out[source, lane] = (_run(dataset, source, d, **over), d)
    return out


@pytest.mark.parametrize("source", ["png", "slbp"])
def test_every_lane_writes_the_same_bytes_and_report(lanes, source):
    ref, ref_dir = lanes[source, "serial"]
    assert len(ref.outputs) == VIEWS and ref.failed == []
    names = sorted(os.listdir(ref_dir))
    for lane in LANES:
        rep, d = lanes[source, lane]
        assert rep.lane == lane
        assert _report_key(rep) == _report_key(ref), lane
        assert sorted(os.listdir(d)) == names
        for name in names:
            assert (d / name).read_bytes() == (ref_dir / name).read_bytes(), (lane, name)
    # one launch a view in the per-view lanes, one a batch (3 + 2) in the others
    assert [lanes[source, lane][0].launches for lane in LANES] == [VIEWS, VIEWS, 2, 2]
    o = lanes[source, "batched"][0].overlap
    assert (o["launches"], o["views_dispatched"], o["max_views_per_launch"]) == (2, VIEWS, 3)
    assert o["max_queue_depth"] >= 1 and o["transfer_bytes_frames"] > 0


def test_the_raw_and_packed_sources_give_the_same_bytes(lanes):
    for lane in LANES:
        a, b = lanes["png", lane][1], lanes["slbp", lane][1]
        for name in os.listdir(a):
            assert (a / name).read_bytes() == (b / name).read_bytes(), (lane, name)


@pytest.mark.parametrize("spec", ["frame.load~view_015deg:permanent",
                                  "compute.view~view_045deg:permanent"],
                         ids=["load", "compute"])
def test_a_failure_gives_the_same_report_in_every_lane(dataset, lanes, tmp_path, spec):
    reports = {}
    for lane, over in LANES.items():
        faults.configure(spec)
        reports[lane] = _run(dataset, "slbp", tmp_path / lane, **over)
        faults.reset()
    keys = {lane: _report_key(r) for lane, r in reports.items()}
    want = keys["serial"]
    victim = spec.split("~")[1].split(":")[0]
    assert [f[0] for f in want[3]] == [victim] and len(want[0]) == VIEWS - 1
    assert want[3][0][1:] == ({"frame": "load", "compute": "compute"}[spec.split(".")[0]],
                              "PermanentFault")
    for lane, key in keys.items():
        assert key == want, lane
        for name in want[0]:   # the survivors' bytes are the fault-free run's
            assert (tmp_path / lane / name).read_bytes() == \
                (lanes["slbp", "serial"][1] / name).read_bytes()


def test_the_batched_lane_matches_the_jax_executor(dataset, lanes, tmp_path):
    jcfg = jconfig.load_config(None, {**DECODE, "parallel.compute_batch": "3",
                                      "parallel.io_workers": "2",
                                      "parallel.prefetch_depth": "1",
                                      "parallel.backend": "jax"})
    jrep = jstages.reconstruct(str(dataset / "calib.npz"), str(dataset / "png"),
                               mode="batch", output=str(tmp_path), cfg=jcfg,
                               log=lambda *a: None)
    rep, out = lanes["png", "batched"]
    assert [os.path.basename(p) for p in jrep.outputs] == \
        [os.path.basename(p) for p in rep.outputs]
    assert jrep.overlap["launches"] == rep.overlap["launches"] == 2
    for p in rep.outputs:
        a = ply.read_ply(p)
        b = jply.read_ply(str(tmp_path / os.path.basename(p)))
        assert len(a["points"]) == len(b["points"]) > 500
        np.testing.assert_array_equal(a["colors"], b["colors"])
        np.testing.assert_allclose(a["points"], b["points"], rtol=1e-6, atol=1e-3)


def test_no_lane_thread_outlives_a_run(lanes):
    """A lane's pools shut down as it returns; their idle threads exit
    within moments (polled for at most 10 s)."""
    import time

    t_end = time.monotonic() + 10.0
    while time.monotonic() < t_end and any(
            t.name.startswith(LANE_THREADS) for t in threading.enumerate()):
        time.sleep(0.01)
    assert not [t.name for t in threading.enumerate() if t.name.startswith(LANE_THREADS)]


def test_the_ascii_writer_equals_the_jax_writer(tmp_path):
    rng = np.random.default_rng(3)
    pts = (rng.normal(0, 100, (257, 3)) * np.array([1, 1, 100])).astype(np.float32)
    cols = rng.integers(0, 256, (257, 3)).astype(np.uint8)
    nrm = rng.normal(0, 1, (257, 3)).astype(np.float32)
    for kw in ({}, {"colors": cols}, {"colors": cols, "normals": nrm}):
        ply.write_ply(str(tmp_path / "port.ply"), pts, binary=False, **kw)
        jply.write_ply(str(tmp_path / "jax.ply"), pts, binary=False, **kw)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got = ply.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(got["points"], pts, atol=6e-5 * np.abs(pts).max())
    ply.write_ply(str(tmp_path / "empty.ply"), pts[:0], binary=False)
    jply.write_ply(str(tmp_path / "jempty.ply"), pts[:0], binary=False)
    assert (tmp_path / "empty.ply").read_bytes() == (tmp_path / "jempty.ply").read_bytes()


def test_the_writeback_queue_orders_raises_and_retries(tmp_path):
    pts = np.zeros((10, 3), np.float32)
    written = []
    with ply.WritebackQueue(on_write=lambda p, dt: written.append(p)) as wbq:
        futs = [wbq.submit(str(tmp_path / f"c{i}.ply"), pts) for i in range(3)]
        bad = wbq.submit(str(tmp_path / "no_dir" / "x.ply"), pts)
        assert [f.result() for f in futs] == [str(tmp_path / f"c{i}.ply") for i in range(3)]
        with pytest.raises(OSError):
            bad.result()
    assert written == [str(tmp_path / f"c{i}.ply") for i in range(3)]
    # a transient write error retries in the writer thread, and the bytes
    # equal a direct write's
    faults.configure("ply.write:transient")
    retries = []
    wbq = ply.WritebackQueue(retry=faults.RetryPolicy(max_retries=2, backoff_base_s=0.0,
                                                      jitter=False),
                             on_retry=lambda p, n, e: retries.append((p, n)))
    path = str(tmp_path / "retried.ply")
    assert wbq.submit(path, pts + 1).result() == path
    wbq.close(timeout_s=5.0)
    assert retries == [(path, 1)]
    ply.write_ply(str(tmp_path / "direct.ply"), pts + 1)
    assert (tmp_path / "retried.ply").read_bytes() == (tmp_path / "direct.ply").read_bytes()


def test_the_schedule_keys_load_and_are_not_dropped(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(config, "_logged", set())
    monkeypatch.setenv("SL3D_PREFETCH_DEPTH", "5")
    assert config.Config().parallel.prefetch_depth == 5
    monkeypatch.delenv("SL3D_PREFETCH_DEPTH")
    cfg = config.Config()
    assert (cfg.parallel.prefetch_depth, cfg.pipeline.fused_clean,
            cfg.pipeline.ascii_output) == (2, False, False)
    jcfg = jconfig.Config()
    jcfg.parallel.prefetch_depth = 3
    jcfg.pipeline.fused_clean = True
    jcfg.pipeline.ascii_output = True
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert (cfg.parallel.prefetch_depth, cfg.pipeline.fused_clean,
            cfg.pipeline.ascii_output) == (3, True, True)
    cfg = config.load_config(None, {"parallel.prefetch_depth": "4",
                                    "pipeline.fused_clean": "true",
                                    "pipeline.ascii_output": "yes"})
    assert (cfg.parallel.prefetch_depth, cfg.pipeline.fused_clean,
            cfg.pipeline.ascii_output) == (4, True, True)
    assert "not ported" not in capsys.readouterr().err


def test_no_schedule_knob_changes_a_view_key(dataset):
    def keys(**over):
        cfg = config.load_config(None, {**DECODE, **over})
        cache = stages.StageCache(str(dataset / "keys"), enabled=False)
        return stages._view_plan(str(dataset / "calib.npz"), str(dataset / "slbp"), cfg,
                                 tuple(stages.CLEAN_STEPS), cache, lambda m: None,
                                 torch.device("cpu"))[2]

    base = keys()
    assert len(base) == VIEWS
    for over in ({"parallel.io_workers": 1}, {"parallel.prefetch_depth": 7},
                 {"parallel.compute_batch": 1}, {"pipeline.fused_clean": True},
                 {"pipeline.packed_ingest": True}, {"pipeline.ascii_output": True}):
        assert keys(**over) == base, over
    assert keys(**{"decode.shadow_val": 41}) != base


def test_the_cli_flags_carry_the_jax_names(dataset, monkeypatch):
    seen = {}

    def fake_reconstruct(calib, target, mode, output, cfg, device):
        seen["reconstruct"] = cfg
        return stages.BatchReport(outputs=["x"])

    def fake_pipeline(calib, target, out, cfg, steps, stl_name, device):
        seen["pipeline"] = cfg
        return stages.PipelineReport()

    monkeypatch.setattr(stages, "reconstruct", fake_reconstruct)
    monkeypatch.setattr(stages, "run_pipeline", fake_pipeline)
    calib = str(dataset / "calib.npz")
    assert cli.main(["reconstruct", str(dataset), "--calib", calib, "--io-workers", "3",
                     "--prefetch-depth", "5"]) == 0
    assert (seen["reconstruct"].parallel.io_workers,
            seen["reconstruct"].parallel.prefetch_depth) == (3, 5)
    for flag, fused in (("--fused-clean", True), ("--no-fused-clean", False)):
        assert cli.main(["pipeline", str(dataset), "--calib", calib, "--out",
                         str(dataset / "o"), "--prefetch-depth", "6", "--ascii",
                         flag]) == 0
        c = seen["pipeline"]
        assert (c.parallel.prefetch_depth, c.pipeline.ascii_output,
                c.pipeline.fused_clean) == (6, True, fused)


def test_the_png_codec_reads_what_pil_writes_and_stands_in_for_it(tmp_path, monkeypatch):
    """The port's PNG reader against PIL on PIL's files and on the port's
    own (libpng's adaptive filters, all five of them here), and on rows of
    forced filters: random, all Sub, all None, and None/Sub/Up only (each
    of the reader's paths); and, with neither cv2 nor PIL importable, a
    capture folder of such PNGs loads through the batched reader to the
    same frames."""
    import struct
    import zlib

    from PIL import Image

    from structured_light_for_3d_model_replication_tpu_torch.io import png

    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:40, 0:50]
    smooth = ((x * 3 + y * 5 + (x * y) % 7) % 256).astype(np.uint8)  # PIL filters Paeth
    noisy = rng.integers(0, 256, (31, 17), dtype=np.uint8)
    rgb = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    kinds = []
    for name, img in (("smooth", smooth), ("noisy", noisy), ("rgb", rgb)):
        Image.fromarray(img).save(str(tmp_path / f"{name}.png"))
        kinds.append(png.write_png(str(tmp_path / f"{name}_port.png"), img))
        for path in (tmp_path / f"{name}.png", tmp_path / f"{name}_port.png"):
            assert np.array_equal(png.read_png(str(path), gray=img.ndim == 2), img)
            assert np.array_equal(np.asarray(Image.open(path)), img)
    assert set(np.concatenate(kinds).tolist()) == {0, 1, 2, 3, 4}
    assert np.array_equal(png.read_png(str(tmp_path / "rgb.png"), gray=True),
                          np.asarray(Image.open(tmp_path / "rgb.png").convert("L")))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    for img in (rng.integers(0, 256, (64, 48), dtype=np.uint8),
                rng.integers(0, 4, (33, 21, 3), dtype=np.uint8) * 85, smooth):
        h, w = img.shape[:2]
        ch = img.shape[2] if img.ndim == 3 else 1
        res = (png._filtered(img.reshape(h, w * ch), ch) & 0xFF).astype(np.uint8)
        for rows in (rng.integers(0, 5, h), np.ones(h, int), np.zeros(h, int),
                     rng.integers(0, 3, h)):
            raw = np.concatenate([rows.astype(np.uint8)[:, None], res[rows, np.arange(h)]], 1)
            path = tmp_path / "forced.png"
            path.write_bytes(png._SIGNATURE
                             + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                          2 if ch == 3 else 0, 0, 0, 0))
                             + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                             + chunk(b"IEND", b""))
            assert np.array_equal(np.asarray(Image.open(path)), img)
            assert np.array_equal(png.read_png(str(path), gray=ch == 1), img)
    # with neither cv2 nor PIL importable, a capture folder of PNGs still loads
    base = ((np.mgrid[0:12, 0:16][1] * 9) % 256).astype(np.int16)
    frames = np.clip(base + rng.integers(-8, 9, (6, 12, 16)), 0, 255).astype(np.uint8)
    imio.save_stack(str(tmp_path / "view"), frames)
    import builtins

    real_import = builtins.__import__

    def no_imaging(name, *a, **k):
        if name in ("cv2", "PIL") or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imaging)
    for workers in (None, 3):
        got, texture = imio.load_stack(str(tmp_path / "view"), io_workers=workers)
        assert np.array_equal(got, frames) and texture.shape == (12, 16, 3)
        assert np.array_equal(texture[..., 1], frames[0])


class _LaterPool:
    """A stand-in for the prefetch pool: a submitted load runs only when
    the test says so, so loads overlap as on the card."""

    def __init__(self):
        self.jobs: list = []

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut = Future()
        self.jobs.append((fut, fn, args))
        return fut

    def run(self, fut) -> None:
        for job in self.jobs:
            if job[0] is fut:
                self.jobs.remove(job)
                fut.set_result(job[1](*job[2]))
                return


@pytest.mark.parametrize("seed", range(4))
def test_a_staging_slot_never_has_two_holders(monkeypatch, seed):
    """The staging ring's bookkeeping, with the packed lane's order of
    releases: a load hands its lease back once its upload is queued, and
    the dispatch of its batch releases the batch's leases again. Loads run
    in a seeded random order. Whenever a load is waiting to fill its pinned
    buffer, no other waiting load holds that slot, and a stale lease can
    neither free nor fill a slot another load holds."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    rng = np.random.default_rng(seed)
    batch_n, depth = 2, 3
    staging = stages._Staging(torch.device("cpu"), depth)
    pool = _LaterPool()

    def load(src, lease):
        staging.release(lease)   # the upload is queued
        return src

    window = stages._Prefetch(pool, load, list(range(40)), depth, staging)

    def check_holders():
        waiting = [lease[0] for _, _, fut, lease in window.inflight if not fut.done()]
        assert len(waiting) == len(set(waiting)), waiting

    window.top_up()
    batch, done = [], []
    while window.inflight:
        for fut, _, _ in [j for j in pool.jobs if rng.random() < 0.3]:
            pool.run(fut)
        check_holders()
        idx, _, fut, lease = window.inflight.popleft()
        window.top_up()
        check_holders()
        pool.run(fut)
        batch.append(lease)
        done.append(idx)
        if len(batch) == batch_n or not window.inflight:
            for stale in batch:
                window.release(stale)   # a second release frees nothing
            window.top_up()
            check_holders()
            batch.clear()
    assert done == list(range(40))
    # a lease whose slot went to another load can neither free nor fill it
    staging = stages._Staging(torch.device("cpu"), 1)
    lease = staging.acquire()
    staging.release(lease)
    holder = staging.acquire()
    staging.release(lease)
    assert holder[0] == lease[0] and staging.acquire() is None
    with pytest.raises(RuntimeError, match="no longer holds"):
        staging.fill(lease, (np.zeros(4, np.uint8),))


def test_the_lanes_count_exactly_under_thread_switches(dataset, lanes, tmp_path):
    """More threads than cores and a tiny switch interval: the launch count
    (bumped by the dispatch and the drain threads) and the report stay
    exact when a fault sends a batch to the per-view lane."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        faults.configure("compute.view~view_000deg:transient")
        rep = _run(dataset, "slbp", tmp_path, **{"parallel.compute_batch": 2,
                                                 "parallel.io_workers": 2 * os.cpu_count(),
                                                 "parallel.prefetch_depth": 3})
    finally:
        sys.setswitchinterval(interval)
    # batch 1 degraded to 2 per-view launches, then two batched launches
    assert (rep.launches, rep.retries, rep.failed) == (4, 1, [])
    assert _report_key(rep) == _report_key(lanes["slbp", "serial"][0])
