"""Synthetic scans: analytic scenes rendered through a synthetic rig (numpy).

Renders Gray-code capture stacks of known geometry (sphere, plane, object on
a background wall) through a projector-camera rig, with the exact projector
coordinates and 3D points of every pixel as ground truth. The tests and
``chip_smoke.py`` use it; no hardware is needed. Same scenes and arithmetic
as the JAX package's module: camera at the origin, x_proj = R x_cam + T,
millimetres.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.calib.geometry import (
    build_calibration,
)
from structured_light_for_3d_model_replication_tpu_torch.ops.graycode import (
    generate_pattern_stack,
)

__all__ = ["Rig", "Sphere", "Plane", "Scene", "default_rig", "render_scene",
           "rotate_y", "sphere_on_background", "turntable_poses",
           "three_spheres", "lumpy_views", "turntable_transforms", "pose_errors",
           "sphere_surface_distance", "surface_distance", "sphere_union_cloud",
           "pipeline_scene"]


@dataclass
class Rig:
    cam_K: np.ndarray
    proj_K: np.ndarray
    R: np.ndarray        # camera -> projector rotation
    T: np.ndarray        # camera -> projector translation (mm)
    cam_size: tuple[int, int]   # (width, height)
    proj_size: tuple[int, int]  # (width, height)

    def calibration(self) -> dict:
        return build_calibration(
            self.cam_K, np.zeros(5), self.proj_K, self.R, self.T,
            self.cam_size[0], self.cam_size[1],
            self.proj_size[0], self.proj_size[1])


def rotate_y(deg: float) -> np.ndarray:
    """Rotation about the +y (vertical) axis — the turntable axis."""
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def default_rig(cam_size=(320, 240), proj_size=(256, 128)) -> Rig:
    """A plausible scanner rig: projector ~150 mm left of the camera, toed in,
    with a vertical baseline too (row planes need it)."""
    cw, ch = cam_size
    pw, ph = proj_size
    cam_K = np.array([[1.1 * cw, 0, cw / 2 - 0.5],
                      [0, 1.1 * cw, ch / 2 - 0.5],
                      [0, 0, 1]], np.float64)
    proj_K = np.array([[1.3 * pw, 0, pw / 2 - 0.5],
                       [0, 1.3 * pw, ph / 2 - 0.5],
                       [0, 0, 1]], np.float64)
    T = np.array([150.0, 80.0, 20.0], np.float64)
    return Rig(cam_K, proj_K, rotate_y(-12.0), T, cam_size, proj_size)


@dataclass
class Sphere:
    center: np.ndarray
    radius: float
    albedo: np.ndarray = field(default_factory=lambda: np.array([0.8, 0.6, 0.4]))

    def intersect(self, origins, dirs):
        """Nearest positive ray parameter t or +inf. origins/dirs: [N,3]."""
        oc = origins - self.center[None, :]
        b = np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - self.radius**2
        disc = b * b - c
        hit = disc >= 0
        sq = np.sqrt(np.where(hit, disc, 0))
        t = np.where(hit, -b - sq, np.inf)
        t = np.where(t > 1e-6, t, np.where(hit, -b + sq, np.inf))
        return np.where(t > 1e-6, t, np.inf)

    def transformed(self, R, t):
        return Sphere(R @ self.center + t, self.radius, self.albedo)


@dataclass
class Plane:
    normal: np.ndarray
    d: float  # plane: normal . x + d = 0
    albedo: np.ndarray = field(default_factory=lambda: np.array([0.5, 0.5, 0.55]))

    def intersect(self, origins, dirs):
        denom = dirs @ self.normal
        numer = origins @ self.normal + self.d
        ok = np.abs(denom) > 1e-9
        t = np.where(ok, -numer / np.where(ok, denom, 1), np.inf)
        return np.where(t > 1e-6, t, np.inf)

    def transformed(self, R, t):
        n2 = R @ self.normal
        return Plane(n2, self.d - n2 @ t, self.albedo)


@dataclass
class Scene:
    """A list of analytic primitives; first hit wins."""

    objects: list

    def transformed(self, R, t):
        return Scene([o.transformed(R, t) for o in self.objects])

    def trace(self, origins, dirs):
        """Returns (t [N], object_index [N]; -1 = miss)."""
        n = dirs.shape[0]
        best_t = np.full(n, np.inf)
        best_i = np.full(n, -1, np.int64)
        for i, obj in enumerate(self.objects):
            t = obj.intersect(origins, dirs)
            closer = t < best_t
            best_t = np.where(closer, t, best_t)
            best_i = np.where(closer, i, best_i)
        return best_t, best_i


def sphere_on_background(depth: float = 420.0, radius: float = 70.0,
                         back_depth: float = 560.0) -> Scene:
    """The canonical test scene: a sphere in front of a background wall."""
    return Scene([
        Sphere(np.array([0.0, 0.0, depth]), radius),
        Plane(np.array([0.0, 0.0, -1.0]), back_depth),
    ])


def render_scene(rig: Rig, scene: Scene, brightness: int = 200,
                 ambient: float = 6.0, noise_sigma: float = 0.0,
                 rng: np.random.Generator | None = None,
                 downsample: int = 1):
    """Render the full Gray-code capture sequence of ``scene`` through ``rig``.

    Returns (frames uint8 [F,H,W], ground_truth dict with the projector
    column/row each camera pixel sees, the true 3D points, the lit mask).
    """
    rng = rng or np.random.default_rng(0)
    cw, ch = rig.cam_size
    pw, ph = rig.proj_size

    u, v = np.meshgrid(np.arange(cw, dtype=np.float64),
                       np.arange(ch, dtype=np.float64))
    x = (u - rig.cam_K[0, 2]) / rig.cam_K[0, 0]
    y = (v - rig.cam_K[1, 2]) / rig.cam_K[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], axis=-1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros_like(dirs)

    t, obj_idx = scene.trace(origins, dirs)
    hit = np.isfinite(t)
    pts = origins + dirs * np.where(hit, t, 0.0)[:, None]

    pp = pts @ rig.R.T + rig.T[None, :]
    in_front = pp[:, 2] > 1e-6
    zz = np.where(in_front, pp[:, 2], 1.0)
    up = rig.proj_K[0, 0] * pp[:, 0] / zz + rig.proj_K[0, 2]
    vp = rig.proj_K[1, 1] * pp[:, 1] / zz + rig.proj_K[1, 2]
    ui = np.round(up).astype(np.int64)
    vi = np.round(vp).astype(np.int64)
    lit = hit & in_front & (ui >= 0) & (ui < pw) & (vi >= 0) & (vi < ph)
    ui_c = np.clip(ui, 0, pw - 1)
    vi_c = np.clip(vi, 0, ph - 1)

    albedos = np.array([o.albedo for o in scene.objects] + [np.zeros(3)])
    alb = albedos[obj_idx][:, :3]  # miss -> index -1 -> zeros row
    gray_alb = alb.mean(axis=-1)

    patterns = generate_pattern_stack(pw, ph, brightness, downsample)
    f = patterns.shape[0]
    seen = patterns[:, vi_c, ui_c].astype(np.float64) * lit[None, :]
    img = seen * gray_alb[None, :] + ambient
    if noise_sigma > 0:
        img = img + rng.normal(0, noise_sigma, img.shape)
    # C order whatever layout the fancy-indexed ``seen`` came in
    frames = np.ascontiguousarray(
        np.clip(img, 0, 255).astype(np.uint8).reshape(f, ch, cw))

    tex = np.clip(
        brightness * alb * lit[:, None] + ambient, 0, 255
    ).astype(np.uint8).reshape(ch, cw, 3)

    gt = {
        "proj_col": ui_c.reshape(ch, cw),
        "proj_row": vi_c.reshape(ch, cw),
        "points": pts.reshape(ch, cw, 3).astype(np.float64),
        "lit": lit.reshape(ch, cw),
        "hit": hit.reshape(ch, cw),
        "object_index": obj_idx.reshape(ch, cw),
        "texture": tex,
    }
    return frames, gt


def turntable_poses(n_views: int = 12, step_deg: float = 30.0,
                    pivot: np.ndarray | None = None):
    """Object poses for a turntable sweep about +y through ``pivot``:
    a list of (R, t) with x_view_i = R @ (x_0 - pivot) + pivot."""
    pivot = np.zeros(3) if pivot is None else np.asarray(pivot, np.float64)
    poses = []
    for i in range(n_views):
        R = rotate_y(step_deg * i)
        poses.append((R, pivot - R @ pivot))
    return poses


def three_spheres() -> Scene:
    """The flagship merge scene (bench.py's ``_merge_scene``): three spheres
    of different sizes, asymmetric about the turntable axis. The 70 mm
    sphere fills most of every view and carries no features, so pairwise
    registration of this scene drifts; ``lumpy_views`` is the scene to hold
    poses against."""
    return Scene([
        Sphere(np.array([0.0, 0.0, 420.0]), 70.0),
        Sphere(np.array([55.0, -40.0, 360.0]), 28.0),
        Sphere(np.array([-48.0, 35.0, 370.0]), 22.0),
    ])


def lumpy_views(poses, n_points: int = 20000, radius: float = 75.0,
                center=(0.0, 0.0, 400.0), visible: float = 0.65,
                noise: float = 0.05, seed: int = 0) -> list[np.ndarray]:
    """Point-cloud views f32 [n_i, 3] of a lumpy closed surface (radius *
    (1 + 0.25 sin(4x) cos(3y)) about ``center``, no rotational symmetry),
    one a pose of ``turntable_poses``: the surface points moved by the pose,
    the ``visible`` share nearest the camera (smallest z) kept, with
    Gaussian noise of ``noise`` mm. A scene that registers, for pose checks."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * (1 + 0.25 * np.sin(4 * d[:, 0]) * np.cos(3 * d[:, 1]))
    base = d * r[:, None] + np.asarray(center, np.float64)
    views = []
    for R, t in poses:
        world = base @ np.asarray(R).T + np.asarray(t)
        vis = world[:, 2] < np.percentile(world[:, 2], 100 * visible)
        views.append((world[vis] + rng.normal(0, noise, (int(vis.sum()), 3)))
                     .astype(np.float32))
    return views


def turntable_transforms(poses) -> list[np.ndarray]:
    """The true merge transforms of ``turntable_poses``: transforms[i] maps
    view i into view 0's frame, x_0 = R_i^T (x_i - t_i)."""
    out = []
    for R, t in poses:
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        out.append(T)
    return out


def pose_errors(estimated, truth) -> tuple[np.ndarray, np.ndarray]:
    """Per view: rotation error in degrees and translation error in mm of
    4x4 ``estimated`` transforms against ``truth``."""
    rot, trans = [], []
    for Te, Tt in zip(estimated, truth):
        Te = np.asarray(Te, np.float64)
        c = (np.trace(Tt[:3, :3].T @ Te[:3, :3]) - 1.0) / 2.0
        rot.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
        trans.append(np.linalg.norm(Te[:3, 3] - Tt[:3, 3]))
    return np.asarray(rot), np.asarray(trans)


def sphere_surface_distance(points: np.ndarray, scene: Scene) -> np.ndarray:
    """Distance [N] from each point to the nearest sphere surface of
    ``scene`` (its Sphere objects)."""
    p = np.asarray(points, np.float64)
    d = [np.abs(np.linalg.norm(p - o.center[None, :], axis=1) - o.radius)
         for o in scene.objects if isinstance(o, Sphere)]
    return np.min(np.stack(d), axis=0)


def surface_distance(points: np.ndarray, scene: Scene) -> np.ndarray:
    """Distance [N] from each point to the nearest surface of ``scene``:
    its spheres and its planes."""
    p = np.asarray(points, np.float64)
    d = [np.abs(np.linalg.norm(p - o.center[None, :], axis=1) - o.radius)
         if isinstance(o, Sphere) else np.abs(p @ o.normal + o.d)
         for o in scene.objects]
    return np.min(np.stack(d), axis=0)


def sphere_union_cloud(scene: Scene, n: int = 200_000, noise: float = 0.05,
                       seed: int = 0) -> np.ndarray:
    """Points f32 [m, 3] sampled uniformly on the outer surface of the union
    of ``scene``'s spheres (samples inside another sphere dropped), with
    Gaussian noise of ``noise`` mm: a closed surface with a known distance
    function (``sphere_surface_distance``), for meshing checks."""
    rng = np.random.default_rng(seed)
    spheres = [o for o in scene.objects if isinstance(o, Sphere)]
    area = np.array([s.radius ** 2 for s in spheres])
    parts = []
    for s, m in zip(spheres, rng.multinomial(n, area / area.sum())):
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = s.center + s.radius * d
        inside = np.zeros(m, bool)
        for o in spheres:
            if o is not s:
                inside |= np.linalg.norm(p - o.center, axis=1) < o.radius
        parts.append(p[~inside])
    pts = np.concatenate(parts)
    return (pts + rng.normal(0.0, noise, pts.shape)).astype(np.float32)


def pipeline_scene(cam_size=(768, 576), proj_size=(512, 256), n_views: int = 24,
                   step_deg: float = 15.0):
    """The scan-to-print scene: ``three_spheres`` on a floor plane 10 mm
    under the big sphere (y = 80, which the turntable leaves in place), at
    ``n_views`` turntable poses ``step_deg`` apart about (0, 0, 400).
    Rendered with manual thresholds and row_mode 1, a 768x576 view holds
    at most ~61k points, so its clean bucket stays <= 65,536 rows.
    Returns (rig, scene, poses)."""
    scene = Scene(three_spheres().objects
                  + [Plane(np.array([0.0, -1.0, 0.0]), 80.0)])
    poses = turntable_poses(n_views, step_deg, np.array([0.0, 0.0, 400.0]))
    return default_rig(cam_size=cam_size, proj_size=proj_size), scene, poses
