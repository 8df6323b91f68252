"""The port's calibration (``calib/``) against the JAX package's, on the same
renders.

Inputs: six chessboard poses (6 x 9 inner corners, 15 mm squares, 450-650 mm
away) rendered by ``utils/synthetic.render_chessboard`` through a 640x480
camera and a 128x64 projector (at 320x240 a square of this board spans 7-10
pixels, less than the 23-pixel window of the sub-pixel refinement, and
detection fails in both packages), plus a pose folder with too few frames
and one with no board. Tolerances: corners, decoded projector coordinates,
observations and preview images equal; per-pose errors and the stereo
solution within rtol 1e-9 (the same OpenCV calls on the same inputs); each
package's ``calib.mat`` loaded by both loaders within rtol 1e-6 (OpenCV runs
on one thread here: its threaded solves reduce in a varying order, and two
runs of the same call differ at 1e-9). Undistort:
points within 1e-6, maps within 1e-4 px, float remaps of [0, 1] images
within 1e-4, uint8 remaps equal but for at most 1e-4 of the pixels, each off
by one.
"""
from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from structured_light_for_3d_model_replication_tpu.calib import chessboard as jcb  # noqa: E402
from structured_light_for_3d_model_replication_tpu.calib import inspect as jinsp  # noqa: E402
from structured_light_for_3d_model_replication_tpu.calib import pipeline as jcp  # noqa: E402
from structured_light_for_3d_model_replication_tpu.io import matfile as jmat  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.calib import chessboard as cb  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.calib import inspect as insp  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.calib import pipeline as cp  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.io import matfile  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.utils import synthetic as syn  # noqa: E402

CAM, PROJ = (640, 480), (128, 64)
BOARD = cb.BoardSpec(rows=6, cols=9, square_size=15.0)
JBOARD = jcb.BoardSpec(rows=6, cols=9, square_size=15.0)
N_POSES = 6


def _quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module", autouse=True)
def _one_cv2_thread():
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(threads)


@pytest.fixture(scope="module")
def rig():
    return syn.default_rig(cam_size=CAM, proj_size=PROJ)


@pytest.fixture(scope="module")
def poses_dir(tmp_path_factory, rig):
    """Six rendered pose folders of PNG frames, a short one and a blank one."""
    root = tmp_path_factory.mktemp("calib_poses")
    boards = syn.calibration_poses(rig, BOARD.rows, BOARD.cols, BOARD.square_size,
                                   n=N_POSES, near=450.0, far=650.0)
    frames = None
    for i, board in enumerate(boards):
        frames = syn.render_chessboard(rig, board)
        imio.save_stack(str(root / f"pose{i + 1:02d}"), frames)
    imio.save_stack(str(root / "short"), frames[:10])
    imio.save_stack(str(root / "blank"), np.full_like(frames, 6))
    return str(root)


def _copy(src: str, dst) -> str:
    shutil.copytree(src, str(dst))
    return str(dst)


@pytest.fixture(scope="module")
def observations(poses_dir, tmp_path_factory):
    """Both packages' collect_calibration_data on copies of the folders:
    ((obs, shape, logs, dir) of the port, the same of the JAX package)."""
    out = []
    for name, mod in (("port", cp), ("jax", jcp)):
        d = _copy(poses_dir, tmp_path_factory.mktemp("collect") / name)
        logs: list[str] = []
        board = BOARD if mod is cp else JBOARD
        obs, shape = mod.collect_calibration_data(d, board=board, proj_size=PROJ,
                                                  log=logs.append)
        out.append((obs, shape, logs, d))
    return out


def test_find_corners_and_preview_equal_the_jax_packages(poses_dir, rig):
    boards = syn.calibration_poses(rig, BOARD.rows, BOARD.cols, BOARD.square_size,
                                   n=N_POSES, near=450.0, far=650.0)
    for i, board in enumerate(boards):
        white = imio.load_color(os.path.join(poses_dir, f"pose{i + 1:02d}", "01.png"))
        gray = cv2.cvtColor(white, cv2.COLOR_RGB2GRAY)
        np.testing.assert_array_equal(cb.enhance_for_detection(gray),
                                      jcb.enhance_for_detection(gray))
        mine, theirs = cb.find_corners(white, BOARD), jcb.find_corners(white, JBOARD)
        assert mine is not None and mine.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(cb.find_corners(gray, BOARD, refine=False),
                                      jcb.find_corners(gray, JBOARD, refine=False))
        np.testing.assert_array_equal(cb.draw_corner_preview(white, mine, BOARD),
                                      jcb.draw_corner_preview(white, theirs, JBOARD))
        # the detected grid sits on the rendered corners (any enumeration order)
        truth = syn._project(rig.cam_K, board.corners())
        d = np.linalg.norm(mine[:, None] - truth[None], axis=2)
        assert d.min(axis=1).max() < 0.25
    np.testing.assert_array_equal(cb.board_object_points(BOARD),
                                  jcb.board_object_points(JBOARD))
    assert cb.find_corners(np.full((480, 640), 6, np.uint8), BOARD) is None


def test_a_missing_cv2_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        cb.find_corners(np.zeros((8, 8), np.uint8), BOARD)
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        cb.enhance_for_detection(np.zeros((8, 8), np.uint8))


def test_decode_at_points_equals_the_jax_packages():
    from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc

    rng = np.random.default_rng(5)
    stack = gc.generate_pattern_stack(*PROJ, brightness=200)[2:]
    noisy = np.clip(stack.astype(np.int16) + rng.integers(-20, 21, stack.shape), 0, 255)
    pts = np.column_stack([rng.uniform(-3, PROJ[0] + 3, 300),
                           rng.uniform(-3, PROJ[1] + 3, 300)])
    for frames in (stack, noisy.astype(np.uint8)):
        mine = cp.decode_at_points(frames, pts, 7, 6)
        theirs = jcp.decode_at_points(frames, pts, 7, 6)
        for a, b in zip(mine, theirs):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    # truncation to the pixel, then the prefix-XOR decode of that pixel
    inside = (pts[:, 0] >= 0) & (pts[:, 1] >= 0) & (pts[:, 0] < PROJ[0]) \
        & (pts[:, 1] < PROJ[1])
    col, row = cp.decode_at_points(stack, pts, 7, 6)
    np.testing.assert_array_equal(col[inside], np.floor(pts[inside, 0]))
    np.testing.assert_array_equal(row[inside], np.floor(pts[inside, 1]))


def test_collect_calibration_data_equals_the_jax_packages(observations):
    (obs, shape, logs, d), (jobs, jshape, jlogs, jd) = observations
    assert shape == jshape == CAM
    assert [o.name for o in obs] == [o.name for o in jobs] == \
        [f"pose{i + 1:02d}" for i in range(N_POSES)]
    for o, j in zip(obs, jobs):
        for field in ("obj_pts", "cam_pts", "proj_pts"):
            a, b = getattr(o, field), getattr(j, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the same skip rules, in the same words
    assert logs == jlogs
    assert any("blank: chessboard not found" in m for m in logs)
    assert any("short: 10 frames < " in m for m in logs)
    names = sorted(os.listdir(os.path.join(d, "corners_preview")))
    assert names == sorted(os.listdir(os.path.join(jd, "corners_preview"))) == \
        [f"pose{i + 1:02d}.png" for i in range(N_POSES)]
    for n in names:
        np.testing.assert_array_equal(
            imio.load_color(os.path.join(d, "corners_preview", n)),
            imio.load_color(os.path.join(jd, "corners_preview", n)))
    with pytest.raises(ValueError, match="no usable calibration poses"):
        cp.collect_calibration_data(os.path.join(d, "blank"), board=BOARD,
                                    proj_size=PROJ, log=_quiet)


def test_errors_selection_and_stereo_solve_equal_the_jax_packages(observations):
    (obs, shape, _, _), (jobs, _, _, _) = observations
    errors = cp.reprojection_errors(obs, shape, PROJ)
    jerrors = jcp.reprojection_errors(jobs, shape, PROJ)
    assert list(errors) == list(jerrors)
    for k in errors:
        np.testing.assert_allclose(errors[k], jerrors[k], rtol=1e-9)
    # the ceilings keep a subset; impossible ceilings fall back to the 3 best
    for ceil in ((1.0, 2.0), (0.0, 0.0), (min(e[0] for e in errors.values()) + 1e-9, 9.0)):
        assert cp.select_poses(errors, *ceil) == jcp.select_poses(jerrors, *ceil)
    assert len(cp.select_poses(errors, 0.0, 0.0)) == 3
    mlog: list[str] = []
    jlog: list[str] = []
    sol = cp.calibrate_stereo(obs, shape, PROJ, log=mlog.append)
    jsol = jcp.calibrate_stereo(jobs, shape, PROJ, log=jlog.append)
    assert mlog == jlog and len(mlog) == 4
    for f in ("cam_K", "cam_dist", "proj_K", "proj_dist", "R", "T"):
        np.testing.assert_allclose(getattr(sol, f), getattr(jsol, f), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    for f in ("rms_stereo", "rms_cam", "rms_proj"):
        np.testing.assert_allclose(getattr(sol, f), getattr(jsol, f), rtol=1e-9)
    assert sol.img_shape == jsol.img_shape and sol.proj_shape == jsol.proj_shape
    assert sol.rms_stereo < 1.0
    with pytest.raises(ValueError, match="at least 3"):
        cp.calibrate_and_save("unused", "unused.mat", observations=obs[:2],
                              img_shape=shape, proj_size=PROJ, log=_quiet)


def _close(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("suffix", [".mat", ".npz"])
def test_calibrate_and_save_files_cross_load(observations, tmp_path, suffix):
    (obs, shape, _, d), (jobs, _, _, jd) = observations
    keep = [o.name for o in obs[:5]]
    mine = str(tmp_path / f"port{suffix}")
    theirs = str(tmp_path / f"jax{suffix}")
    sol = cp.calibrate_and_save(d, mine, selected_poses=keep, board=BOARD,
                                proj_size=PROJ, observations=obs, img_shape=shape,
                                log=_quiet)
    jsol = jcp.calibrate_and_save(jd, theirs, selected_poses=keep, board=JBOARD,
                                  proj_size=PROJ, observations=jobs, img_shape=shape,
                                  log=_quiet)
    np.testing.assert_allclose(sol.cam_K, jsol.cam_K, rtol=1e-9)
    loaded = [load(p) for p in (mine, theirs)
              for load in (matfile.load_calibration, jmat.load_calibration)]
    for other in loaded[1:]:
        _close(loaded[0], other)
    assert loaded[0]["Nc"].shape == (3, CAM[0] * CAM[1])


def test_calibrate_and_save_from_disk_equals_the_jax_packages(observations, tmp_path):
    """Without cached observations both packages re-read the selected pose
    folders."""
    (_, _, _, d), (_, _, _, jd) = observations
    keep = ["pose01", "pose03", "pose04", "pose06"]
    cp.calibrate_and_save(d, str(tmp_path / "a.mat"), selected_poses=keep, board=BOARD,
                          proj_size=PROJ, include_ray_field=False, log=_quiet)
    jcp.calibrate_and_save(jd, str(tmp_path / "b.mat"), selected_poses=keep,
                           board=JBOARD, proj_size=PROJ, include_ray_field=False,
                           log=_quiet)
    a = matfile.load_calibration(str(tmp_path / "a.mat"))
    _close(a, jmat.load_calibration(str(tmp_path / "b.mat")))
    assert "Nc" not in a


def test_summary_format_and_plot_equal_the_jax_packages(observations, tmp_path):
    (obs, shape, _, _), _ = observations
    sol = cp.calibrate_stereo(obs, shape, PROJ, log=_quiet)
    from structured_light_for_3d_model_replication_tpu_torch.calib.geometry import (
        build_calibration,
    )

    calib = build_calibration(sol.cam_K, sol.cam_dist, sol.proj_K, sol.R, sol.T,
                              CAM[0], CAM[1], PROJ[0], PROJ[1], include_ray_field=False)
    for err in (None, 0.3, 0.7, 1.5):
        s = insp.summarize_calibration(calib, err)
        assert s == jinsp.summarize_calibration(calib, err)
        assert insp.format_summary(s) == jinsp.format_summary(s)
    for R in (sol.R, np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])):
        assert insp.euler_angles_deg(R) == jinsp.euler_angles_deg(R)
    assert [insp.quality_band(e) for e in (0.49, 0.5, 0.99, 1.0)] == \
        ["EXCELLENT", "GOOD", "GOOD", "POOR"]
    pytest.importorskip("matplotlib")
    from structured_light_for_3d_model_replication_tpu.calib import visualize as jvis
    from structured_light_for_3d_model_replication_tpu_torch.calib import visualize

    info = visualize.plot_rig(calib, str(tmp_path / "rig.png"))
    jinfo = jvis.plot_rig(calib, str(tmp_path / "jrig.png"))
    with open(tmp_path / "rig.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert info["plot"] == str(tmp_path / "rig.png")
    assert info["baseline_mm"] == jinfo["baseline_mm"]
    assert info["euler_deg"] == jinfo["euler_deg"]
    np.testing.assert_array_equal(visualize.frustum_corners(sol.cam_K, *CAM, 300.0),
                                  jvis.frustum_corners(sol.cam_K, *CAM, 300.0))


# ---------------------------------------------------------------------------
# undistort
# ---------------------------------------------------------------------------

K_SMALL = np.array([[352.0, 0, 159.5], [0, 352.0, 119.5], [0, 0, 1]])
DIST = np.array([-0.28, 0.12, 1e-3, -5e-4, -0.02])


def test_undistort_points_and_map_match_the_jax_packages():
    from structured_light_for_3d_model_replication_tpu.calib import undistort as jud
    from structured_light_for_3d_model_replication_tpu_torch.calib import undistort as ud

    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.6, 0.6, (400, 2))
    for dist in (DIST, DIST[:4], np.concatenate([DIST, [0.01, 0.02, 0.03]])):
        for fn in ("distort_points", "undistort_points"):
            mine = getattr(ud, fn)(pts, dist, device="cpu")
            assert mine.dtype.is_floating_point and mine.device.type == "cpu"
            np.testing.assert_allclose(mine.numpy(), np.asarray(getattr(jud, fn)(pts, dist)),
                                       rtol=0, atol=1e-6, err_msg=fn)
        m = ud.undistort_map(K_SMALL, dist, width=320, height=240, device="cpu").numpy()
        jm = np.asarray(jud.undistort_map(K_SMALL, dist, width=320, height=240))
        assert m.shape == (240, 320, 2)
        np.testing.assert_allclose(m, jm, rtol=0, atol=1e-4)
    # the fixed-point inverse undoes the forward model
    back = ud.undistort_points(ud.distort_points(pts, DIST, device="cpu"), DIST,
                               device="cpu").numpy()
    np.testing.assert_allclose(back, pts, atol=2e-4)


def test_undistort_remaps_match_the_jax_packages():
    from structured_light_for_3d_model_replication_tpu.calib import undistort as jud
    from structured_light_for_3d_model_replication_tpu_torch.calib import undistort as ud

    rng = np.random.default_rng(4)
    stack = rng.integers(0, 256, (6, 240, 320), dtype=np.uint8)
    mine = ud.undistort_stack(stack, K_SMALL, DIST, device="cpu").numpy()
    theirs = np.asarray(jud.undistort_stack(stack, K_SMALL, DIST))
    assert mine.dtype == np.uint8 and mine.shape == stack.shape
    diff = np.abs(mine.astype(np.int16) - theirs)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    # one image, gray and color, integer and float in [0, 1]
    color = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    for img in (stack[0], color):
        d = np.abs(ud.undistort_image(img, K_SMALL, DIST, device="cpu").numpy()
                   .astype(np.int16) - np.asarray(jud.undistort_image(img, K_SMALL, DIST)))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4
        f = img.astype(np.float32) / 255.0
        np.testing.assert_allclose(ud.undistort_image(f, K_SMALL, DIST, device="cpu").numpy(),
                                   np.asarray(jud.undistort_image(f, K_SMALL, DIST)),
                                   rtol=0, atol=1e-4)
    # remap_bilinear at an arbitrary map, border-clamped
    sample = rng.uniform(-5, 330, (60, 80, 2)).astype(np.float32)
    f = stack[1].astype(np.float32) / 255.0
    np.testing.assert_allclose(ud.remap_bilinear(f, sample, device="cpu").numpy(),
                               np.asarray(jud.remap_bilinear(f, sample)), rtol=0, atol=1e-4)


def test_undistort_identity_truncation_and_device():
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.calib import undistort as ud

    rng = np.random.default_rng(6)
    stack = rng.integers(0, 256, (3, 240, 320), dtype=np.uint8)
    out = ud.undistort_stack(stack, K_SMALL, np.zeros(5), device="cpu")
    np.testing.assert_array_equal(out.numpy(), stack)
    # uint8 blends truncate: halfway between 10 and 13 is 11.5 -> 11
    img = np.array([[10, 13]], np.uint8)
    half = np.array([[[0.5, 0.0]]], np.float32)
    assert ud.remap_bilinear(img, half, device="cpu").item() == 11
    if not torch.cuda.is_available():
        for call in (lambda: ud.undistort_stack(stack, K_SMALL, DIST),
                     lambda: ud.undistort_map(K_SMALL, DIST, width=4, height=3),
                     lambda: ud.distort_points(np.zeros((1, 2)), DIST)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
