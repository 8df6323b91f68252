"""Lens undistortion (Brown-Conrady model) in PyTorch.

The inverse-distortion map is a fixed-point iteration with a fixed trip
count, and the remap is a clipped gather plus a bilinear blend; an
undistorted stack builds one map and remaps every frame with it in one
batch. Plain PyTorch ops in float32 (the JAX package computes them in plain
jnp, outside any Pallas kernel). The distortion polynomial rounds each
multiply-add once (``_fma``), as the JAX package's compiled CPU code does,
so the two packages' maps agree bit for bit; zero distortion is the exact
identity map (the round trip through normalized coordinates would miss the
pixel grid by an ulp at some pixels, and a truncating uint8 cast would turn
that into off-by-one values).

Distortion model (k1, k2, p1, p2, k3), OpenCV's ordering, so a saved ``dc``
vector drops straight in. Every entry point takes ``device`` (``None``
means ``cuda``; a CUDA request without CUDA raises) and returns tensors on
that device.
"""
from __future__ import annotations

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = [
    "distort_points",
    "undistort_points",
    "undistort_map",
    "remap_bilinear",
    "undistort_image",
    "undistort_stack",
]


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _split_dist(dist, dev: torch.device):
    """(k1, k2, p1, p2, k3): ``dist`` cut or zero-padded to 5 entries, f32."""
    flat = _f32(dist, dev).reshape(-1)[:5]
    d = torch.zeros(5, dtype=torch.float32, device=dev)
    d[: flat.shape[0]] = flat
    return d[0], d[1], d[2], d[3], d[4]


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (the f64 product of two f32 values
    is exact)."""
    return (a.double() * b.double() + c.double()).float()


def distort_points(pts_norm, dist, device=None) -> torch.Tensor:
    """Apply forward Brown-Conrady distortion to normalized coords [..., 2]:
    ``r2 = x^2 + y^2``, ``radial = 1 + r2 (k1 + r2 (k2 + r2 k3))``,
    ``xd = x radial + 2 p1 x y + p2 (r2 + 2 x^2)``,
    ``yd = y radial + p1 (r2 + 2 y^2) + 2 p2 x y``."""
    dev = resolve_device(device)
    pts = _f32(pts_norm, dev)
    k1, k2, p1, p2, k3 = _split_dist(dist, dev)
    x, y = pts[..., 0], pts[..., 1]
    one = torch.ones((), dtype=torch.float32, device=dev)
    r2 = _fma(x, x, y * y)
    radial = _fma(r2, _fma(r2, _fma(r2, k3, k2), k1), one)
    xd = _fma(p2, _fma(2.0 * x, x, r2), _fma(2.0 * p1 * x, y, x * radial))
    yd = _fma(2.0 * p2 * x, y, _fma(p1, _fma(2.0 * y, y, r2), y * radial))
    return torch.stack([xd, yd], dim=-1)


def undistort_points(pts_norm, dist, iters: int = 8, device=None) -> torch.Tensor:
    """Invert the distortion by fixed-point iteration (8 steps converge past
    f32 resolution for consumer-lens coefficients)."""
    dev = resolve_device(device)
    pts = _f32(pts_norm, dev)
    und = pts
    for _ in range(iters):
        und = und + (pts - distort_points(und, dist, device=dev))
    return und


def undistort_map(K, dist, *, width: int, height: int, device=None) -> torch.Tensor:
    """Sampling map [H, W, 2]: for each undistorted output pixel, the (x, y)
    source location in the distorted input image."""
    dev = resolve_device(device)
    K = _f32(K, dev)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    if not bool(torch.stack(_split_dist(dist, dev)).any()):
        return torch.stack([u, v], dim=-1)   # no distortion: the pixel grid
    norm = torch.stack([(u - cx) / fx, (v - cy) / fy], dim=-1)
    dist_norm = distort_points(norm, dist, device=dev)
    sx = _fma(dist_norm[..., 0], fx, cx)
    sy = _fma(dist_norm[..., 1], fy, cy)
    return torch.stack([sx, sy], dim=-1)


def _remap(img: torch.Tensor, sample_map: torch.Tensor, batched: bool) -> torch.Tensor:
    """Bilinear resample of ``img`` ([F,] H, W(, C)) at ``sample_map``
    [h, w, 2]; out-of-bounds samples clamp to the border (clipped gather
    indices). An integer image comes back through a truncating cast."""
    h, w = img.shape[1:3] if batched else img.shape[:2]
    x, y = sample_map[..., 0], sample_map[..., 1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = torch.clamp(x - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(y - y0.to(torch.float32), 0.0, 1.0)
    if img.dim() == (4 if batched else 3):   # color: blend every channel alike
        fx, fy = fx[..., None], fy[..., None]

    def at(yi, xi):
        return (img[:, yi, xi] if batched else img[yi, xi]).to(torch.float32)

    p00, p01, p10, p11 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    out = top * (1 - fy) + bot * fy
    if img.dtype.is_floating_point:
        return out
    return out.to(img.dtype)


def _image(img, dev: torch.device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img.to(dev)
    return torch.as_tensor(np.ascontiguousarray(img), device=dev)


def remap_bilinear(img, sample_map, device=None) -> torch.Tensor:
    """Bilinear resample of ``img`` [H, W(, C)] at ``sample_map`` [h, w, 2]
    (x, y); border-clamped, integer images truncated back to their dtype."""
    dev = resolve_device(device)
    return _remap(_image(img, dev), _f32(sample_map, dev), batched=False)


def undistort_image(img, K, dist, device=None) -> torch.Tensor:
    """Undistort one image [H, W(, C)]."""
    dev = resolve_device(device)
    img = _image(img, dev)
    m = undistort_map(K, dist, width=img.shape[1], height=img.shape[0], device=dev)
    return _remap(img, m, batched=False)


def undistort_stack(frames, K, dist, device=None) -> torch.Tensor:
    """Undistort a capture stack [F, H, W]: one map, all F frames remapped
    with it in one batch."""
    dev = resolve_device(device)
    f = _image(frames, dev)
    m = undistort_map(K, dist, width=f.shape[2], height=f.shape[1], device=dev)
    return _remap(f, m, batched=True)
