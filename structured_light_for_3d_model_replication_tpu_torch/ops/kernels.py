"""Kernel wrappers, their plain versions, and launch counts.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel
family is a CUDA C++ kernel, the scan path's in ``csrc/decode.cu``, the
merge path's and the clean chain's in ``csrc/cloud.cu``:

  decode_maps         Gray decode of raw frames      (_decode_kernel[_views])
  decode_packed_maps  Gray decode of packed bits     (_decode_packed_kernel[_views])
  scan_fused          decode + quadratic triangulate (_scan_fused_kernel)
  nn1                 brute 1-NN, leading pair axis  (_nn1_kernel)
  ransac_score        RANSAC hypothesis inlier counts (_ransac_score_kernel)
  knn_mean            exact k-NN mean over a cloud   (_knn_mean_kernel;
                      one selection sweep for k <= 128, bisection above)
  slab_mean_knn       the same over x-sorted windows (_slab_bisect_kernel;
                      one selection sweep for k <= 128, bisection above)
  radius_count        neighbours within r, self excluded (_radius_kernel)
  knn_binmin          each bin's nearest column      (no Pallas original:
                      the partial reduce of XLA's lax.approx_min_k)

For tensors on the CPU a wrapper runs its plain PyTorch version
(``*_plain``, the same function written with tensor ops, in the kernel's
float order; the plain k-NN means select the k-th distance with
``torch.topk`` where the kernels bisect or keep a sorted k-list, which
gives the same value). For CUDA tensors it checks device, dtype, shape and
contiguity, allocates the outputs, launches the kernel on the current stream
and raises on a non-zero CUDA error — there is no fallback. Each wrapper
counts its launches in ``<wrapper>.launches``, under one lock: the
pipeline's register lane launches from its own thread. The plain versions
chunk their rows, so none materializes an N x N matrix.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import _build
from structured_light_for_3d_model_replication_tpu_torch.ops.knn import FAR, sq_dist

__all__ = ["decode_maps", "decode_maps_plain", "decode_packed_maps",
           "decode_packed_maps_plain", "scan_fused", "scan_fused_plain",
           "scan_scalars", "sqrt_f32", "nn1", "nn1_plain", "ransac_score",
           "ransac_score_plain", "knn_mean", "knn_mean_plain", "slab_mean_knn",
           "slab_mean_knn_plain", "SELECT_MAX_K", "radius_count",
           "radius_count_plain", "binmin_bins", "bin_minima", "knn_binmin", "knn_binmin_plain",
           "BINMIN_ALPHA", "BINMIN_BETA", "BINMIN_ACC", "binmin_screen_terms",
           "binmin_margin", "binmin_stats", "binmin_mma_probe",
           "KERNELS", "launch_counts", "reset_launch_counts"]

# ---------------------------------------------------------------------------
# the C interface (csrc/decode.cu, csrc/cloud.cu)
# ---------------------------------------------------------------------------

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "slscan_decode_maps": [_P] * 5 + [_I, _I, _L] + [_I] * 8 + [_P],
    "slscan_decode_packed_maps": [_P] * 7 + [_I, _I, _L] + [_I] * 8 + [_P],
    "slscan_scan_fused": [_P] * 7 + [_I, _I, _L] + [_I] * 9 + [_P],
    "slscan_nn1": [_P] * 4 + [_I] * 3 + [_P],
    "slscan_ransac_score": [_P] * 3 + [_F, _P, _I, _I, _P],
    "slscan_knn_mean": [_P, _I, _I, _I, _P, _P, _P],
    "slscan_knn_mean_bisect": [_P, _I, _I, _I, _P, _P, _P],
    "slscan_slab_mean_knn": [_P] + [_I] * 5 + [_F] + [_P] * 4,
    "slscan_slab_mean_knn_bisect": [_P] + [_I] * 5 + [_F] + [_P] * 4,
    "slscan_radius_count": [_P, _I, _F, _P, _P],
    "slscan_knn_binmin": [_P, _P] + [_I] * 4 + [_P, _F, _F] + [_P] * 6,
    "slscan_bm_mma_probe": [_P] * 4 + [_I, _P],
}
_declared: set[int] = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    if id(lib) not in _declared:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.slscan_error_string.argtypes = [ctypes.c_int]
        lib.slscan_error_string.restype = ctypes.c_char_p
        _declared.add(id(lib))
    return lib


_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel (``+=`` on an attribute is not
    atomic across threads)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


_first_ms: dict[str, float] | None = None   # set by first_launch_ms()


@contextlib.contextmanager
def first_launch_ms():
    """Record, inside the block, each kernel entry's first launch: its
    device time in ms (CUDA events around the launch on the current
    stream), keyed by entry name. Yields the dict it fills (``warmup``'s
    first-launch table); later launches are not timed."""
    global _first_ms
    prev, _first_ms = _first_ms, {}
    try:
        yield _first_ms
    finally:
        _first_ms = prev


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _lib()
    rec = _first_ms
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        stream = cur.cuda_stream
        if rec is not None and name not in rec:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record(cur)
            err = getattr(lib, name)(*args, stream)
            t1.record(cur)
            t1.synchronize()
            rec[name] = t0.elapsed_time(t1)
        else:
            err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.slscan_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (kernel);
    mixed devices or another device type raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type == "cpu"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (shape "
                         f"{tuple(t.shape)}, strides {t.stride()})")


def _vec(hw: int, *tensors: torch.Tensor) -> int:
    """4 pixels a thread where every row of pixels is 16-byte aligned."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if hw % 4 == 0 and aligned else 1


def _avail(n_use: int, pairs_from_start: int) -> int:
    """Bit pairs of one axis present in a (possibly truncated) stack."""
    return max(0, min(n_use, pairs_from_start))


def _cascade(bit_of, n_use: int, avail: int, n_bits: int, downsample: int,
             like: torch.Tensor) -> torch.Tensor:
    """Gray -> binary, MSB first: binary_b = binary_{b-1} ^ g_b, with g = 0
    for pairs past the end of the stack; then the rescale shift."""
    binary = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    prev = torch.zeros_like(binary)
    for b in range(n_use):
        if b < avail:
            prev = prev ^ bit_of(b).to(torch.int32)
        binary = (binary << 1) | prev
    return (binary << (n_bits - n_use)) * downsample


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (IEEE ``sqrtf``, numpy's
    ``sqrt``) on every device: the float64 root of a float32 value rounds
    to it. PyTorch's vectorized CPU sqrt is off by one ulp on some inputs."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _shadow_mask(white: torch.Tensor, black: torch.Tensor,
                 thr_v: torch.Tensor) -> torch.Tensor:
    """Widen to f32 before the subtraction: uint8 would wrap below 0."""
    w = white.to(torch.float32)
    b = black.to(torch.float32)
    thr = thr_v.to(torch.float32)
    return (w > thr[:, 0, None, None]) & ((w - b) > thr[:, 1, None, None])


# ---------------------------------------------------------------------------
# K1: decode_maps
# ---------------------------------------------------------------------------

def decode_maps_plain(frames_v, thr_v, *, n_bits_col: int, n_bits_row: int,
                      n_use_col: int, n_use_row: int, downsample: int = 1):
    """frames u8 [V, F, H, W], thr f32 [V, 2] (shadow, contrast) ->
    (col i32 [V, H, W], row i32 [V, H, W], mask bool [V, H, W])."""
    f = frames_v.shape[1]
    like = frames_v[:, 0]
    mask = _shadow_mask(frames_v[:, 0], frames_v[:, 1], thr_v)

    def axis(start, n_bits, n_use):
        return _cascade(
            lambda b: frames_v[:, start + 2 * b] > frames_v[:, start + 2 * b + 1],
            n_use, _avail(n_use, (f - start) // 2), n_bits, downsample, like)

    return (axis(2, n_bits_col, n_use_col),
            axis(2 + 2 * n_bits_col, n_bits_row, n_use_row), mask)


def decode_maps(frames_v, thr_v, *, n_bits_col: int, n_bits_row: int,
                n_use_col: int, n_use_row: int, downsample: int = 1):
    """Gray decode of a raw [V, F, H, W] u8 stack (see decode_maps_plain).
    A stack shorter than the full sequence decodes the missing pairs as 0."""
    kw = dict(n_bits_col=n_bits_col, n_bits_row=n_bits_row,
              n_use_col=n_use_col, n_use_row=n_use_row, downsample=downsample)
    if _on_cpu(frames_v, thr_v):
        return decode_maps_plain(frames_v, thr_v, **kw)
    if frames_v.dim() != 4:
        raise ValueError(f"frames: expected [V, F, H, W], got {tuple(frames_v.shape)}")
    v, f, h, w = frames_v.shape
    if f < 2:
        raise ValueError(f"frames: need white and black frames, got F={f}")
    _check(frames_v, "frames", torch.uint8, (v, f, h, w))
    _check(thr_v, "thr", torch.float32, (v, 2))
    col = torch.empty((v, h, w), dtype=torch.int32, device=frames_v.device)
    row = torch.empty_like(col)
    mask = torch.empty((v, h, w), dtype=torch.bool, device=frames_v.device)
    _launch("slscan_decode_maps", frames_v.device,
            frames_v.data_ptr(), thr_v.data_ptr(), col.data_ptr(),
            row.data_ptr(), mask.data_ptr(), v, f, h * w,
            _vec(h * w, frames_v), n_bits_col, n_bits_row, n_use_col,
            n_use_row, _avail(n_use_col, (f - 2) // 2),
            _avail(n_use_row, (f - 2 - 2 * n_bits_col) // 2), downsample)
    _count(decode_maps)
    return col, row, mask


# ---------------------------------------------------------------------------
# K2: decode_packed_maps
# ---------------------------------------------------------------------------

def decode_packed_maps_plain(planes_v, white_v, black_v, thr_v, *,
                             n_pairs: int, n_bits_col: int, n_bits_row: int,
                             n_use_col: int, n_use_row: int,
                             downsample: int = 1):
    """planes u8 [V, Pb, H, W] (pair p at byte p>>3, bit p&7), white/black
    u8 [V, H, W], thr f32 [V, 2]; ``n_pairs`` pattern pairs in the stack ->
    (col, row, mask) as decode_maps."""
    mask = _shadow_mask(white_v, black_v, thr_v)

    def axis(start, n_bits, n_use):
        def bit_of(b):
            p = start + b
            return (planes_v[:, p >> 3] >> (p & 7)) & 1

        return _cascade(bit_of, n_use, _avail(n_use, n_pairs - start), n_bits,
                        downsample, white_v)

    return (axis(0, n_bits_col, n_use_col),
            axis(n_bits_col, n_bits_row, n_use_row), mask)


def decode_packed_maps(planes_v, white_v, black_v, thr_v, *, n_pairs: int,
                       n_bits_col: int, n_bits_row: int, n_use_col: int,
                       n_use_row: int, downsample: int = 1):
    """Gray decode straight from packed bit-planes (see the plain version)."""
    kw = dict(n_pairs=n_pairs, n_bits_col=n_bits_col, n_bits_row=n_bits_row,
              n_use_col=n_use_col, n_use_row=n_use_row, downsample=downsample)
    if _on_cpu(planes_v, white_v, black_v, thr_v):
        return decode_packed_maps_plain(planes_v, white_v, black_v, thr_v, **kw)
    if planes_v.dim() != 4:
        raise ValueError(f"planes: expected [V, Pb, H, W], got {tuple(planes_v.shape)}")
    v, pb, h, w = planes_v.shape
    if pb > 8 or n_pairs > 8 * pb:
        raise ValueError(f"planes: {pb} plane bytes for {n_pairs} pairs "
                         f"(the kernel holds at most 64 pairs)")
    _check(planes_v, "planes", torch.uint8, (v, pb, h, w))
    _check(white_v, "white", torch.uint8, (v, h, w))
    _check(black_v, "black", torch.uint8, (v, h, w))
    _check(thr_v, "thr", torch.float32, (v, 2))
    col = torch.empty((v, h, w), dtype=torch.int32, device=planes_v.device)
    row = torch.empty_like(col)
    mask = torch.empty((v, h, w), dtype=torch.bool, device=planes_v.device)
    _launch("slscan_decode_packed_maps", planes_v.device,
            planes_v.data_ptr(), white_v.data_ptr(), black_v.data_ptr(),
            thr_v.data_ptr(), col.data_ptr(), row.data_ptr(), mask.data_ptr(),
            v, pb, h * w, _vec(h * w, planes_v, white_v, black_v),
            n_bits_col, n_bits_row, n_use_col, n_use_row,
            _avail(n_use_col, n_pairs), _avail(n_use_row, n_pairs - n_bits_col),
            downsample)
    _count(decode_packed_maps)
    return col, row, mask


# ---------------------------------------------------------------------------
# K3: scan_fused
# ---------------------------------------------------------------------------

def scan_scalars(oc: torch.Tensor, poly_col: torch.Tensor,
                 poly_row: torch.Tensor, epipolar_tol: float) -> torch.Tensor:
    """The fused kernel's f32[32] scalars on ``oc``'s device: oc xyz @0..2,
    epipolar tolerance @3, column-plane quadratic @4..15, row-plane
    quadratic @16..27 (each [3, 4] row-major: rows A, B, C of (nx, ny, nz, d)).
    Built by device ops alone (no host copy), so the host never waits."""
    f32 = torch.float32
    return torch.cat([oc.reshape(3).to(f32),
                      oc.new_full((1,), epipolar_tol, dtype=f32),
                      poly_col.reshape(12).to(f32), poly_row.reshape(12).to(f32),
                      oc.new_zeros(4, dtype=f32)])


def scan_fused_plain(frames_v, thr_v, scalars, rays, *, n_bits_col: int,
                     n_bits_row: int, n_use_col: int, n_use_row: int,
                     n_cols: int, n_rows: int, row_mode: int,
                     downsample: int = 1):
    """frames u8 [V, F, H, W], thr f32 [V, 2], scalars f32 [32]
    (scan_scalars), rays f32 [H*W, 3] -> (points f32 [V, H*W, 3],
    valid bool [V, H*W], tex u8 [V, H*W] = frame 0). row_mode 0 or 1."""
    v, _, h, w = frames_v.shape
    n = h * w
    col, row, mask = decode_maps_plain(
        frames_v, thr_v, n_bits_col=n_bits_col, n_bits_row=n_bits_row,
        n_use_col=n_use_col, n_use_row=n_use_row)
    sc = scalars
    ox, oy, oz, eps = sc[0], sc[1], sc[2], sc[3]
    rx, ry, rz = rays[:, 0], rays[:, 1], rays[:, 2]

    def poly_plane(idx, n_planes, base):
        i = torch.clamp(idx.reshape(v, n) * downsample, 0, n_planes - 1)
        i = i.to(torch.float32)
        nx, ny, nz, d = (sc[base + c] + i * (sc[base + 4 + c] + i * sc[base + 8 + c])
                         for c in range(4))
        # IEEE sqrt and true divides, the fused kernel's float order (not rsqrt)
        nrm = sqrt_f32(torch.maximum(nx * nx + ny * ny + nz * nz,
                                      sc.new_tensor(1e-30)))
        return nx / nrm, ny / nrm, nz / nrm, d / nrm

    nx, ny, nz, d = poly_plane(col, n_cols, 4)
    denom = nx * rx + ny * ry + nz * rz
    numer = nx * ox + ny * oy + nz * oz + d
    ok = denom.abs() > 1e-6
    t = torch.where(ok, -numer / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(denom))
    px = ox + rx * t
    py = oy + ry * t
    pz = oz + rz * t
    valid = mask.reshape(v, n) & ok
    if row_mode == 1:
        mx, my, mz, dr = poly_plane(row, n_rows, 16)
        dist = (mx * px + my * py + mz * pz + dr).abs()
        valid = valid & (dist < eps)
    return (torch.stack([px, py, pz], dim=-1), valid,
            frames_v[:, 0].reshape(v, n))


def scan_fused(frames_v, thr_v, scalars, rays, *, n_bits_col: int,
               n_bits_row: int, n_use_col: int, n_use_row: int, n_cols: int,
               n_rows: int, row_mode: int, downsample: int = 1):
    """Capture stack -> 3D points in one pass (see scan_fused_plain). Needs
    the full sequence: F >= 2 + 2 * (n_bits_col + n_bits_row).

    ``scan_fused_bulk_kernel`` where every buffer is 16-byte aligned and
    H*W % 16 == 0: one block an SM streams each tile's frame rows into
    shared memory by bulk asynchronous copies and reads the tile's rays
    once for all views; otherwise ``scan_fused_kernel``, one pixel a
    thread. One launch either way."""
    kw = dict(n_bits_col=n_bits_col, n_bits_row=n_bits_row,
              n_use_col=n_use_col, n_use_row=n_use_row, n_cols=n_cols,
              n_rows=n_rows, row_mode=row_mode, downsample=downsample)
    if row_mode not in (0, 1):
        raise ValueError(f"scan_fused: row_mode must be 0 or 1, got {row_mode}")
    if _on_cpu(frames_v, thr_v, scalars, rays):
        return scan_fused_plain(frames_v, thr_v, scalars, rays, **kw)
    if frames_v.dim() != 4:
        raise ValueError(f"frames: expected [V, F, H, W], got {tuple(frames_v.shape)}")
    v, f, h, w = frames_v.shape
    need = 2 + 2 * (n_bits_col + n_bits_row)
    if f < need:
        raise ValueError(f"scan_fused: {f} frames < {need} (truncated stacks "
                         f"take the decode + triangulate path)")
    _check(frames_v, "frames", torch.uint8, (v, f, h, w))
    _check(thr_v, "thr", torch.float32, (v, 2))
    _check(scalars, "scalars", torch.float32, (32,))
    _check(rays, "rays", torch.float32, (h * w, 3))
    dev = frames_v.device
    pts = torch.empty((v, h * w, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((v, h * w), dtype=torch.bool, device=dev)
    tex = torch.empty((v, h * w), dtype=torch.uint8, device=dev)
    _launch("slscan_scan_fused", dev, frames_v.data_ptr(), thr_v.data_ptr(),
            scalars.data_ptr(), rays.data_ptr(), pts.data_ptr(),
            valid.data_ptr(), tex.data_ptr(), v, f, h * w,
            _vec(h * w, frames_v, rays), n_bits_col, n_bits_row, n_use_col,
            n_use_row, n_cols, n_rows, row_mode, downsample)
    _count(scan_fused)
    return pts, valid, tex


# ---------------------------------------------------------------------------
# merge-path kernels (csrc/cloud.cu)
# ---------------------------------------------------------------------------

_ROWS = 1 << 24          # elements per chunk of a plain version's [rows, cols] block
_SELF_BITS = 0x7FFFFFFE  # a query's own slot: above every cutoff


def _sq_f32(r: float) -> torch.Tensor:
    """f32(r) * f32(r), rounded to f32 (the JAX package's float32(r) ** 2)."""
    r32 = torch.tensor(r, dtype=torch.float32)
    return r32 * r32


def _sq_bits(r: float) -> int:
    """Bit pattern of the f32 square of f32(r)."""
    return int(_sq_f32(r).view(torch.int32))


# knn_mean's cutoff: candidates within 1e17 mm^2 are real (invalid rows park at 1e9)
_KNN_R2_BITS = int(torch.tensor(1e17, dtype=torch.float32).view(torch.int32))


# K4: nn1 ---------------------------------------------------------------------

def nn1_plain(q: torch.Tensor, base: torch.Tensor):
    """q f32 [P, Nq, 3], base f32 [P, Nb, 3] -> (idx i32 [P, Nq], d2 f32
    [P, Nq]): the nearest base row of every query, lowest index on ties."""
    p, nq, _ = q.shape
    step = max(1, _ROWS // max(1, p * base.shape[1]))
    idx, d2 = [], []
    for s in range(0, nq, step):
        d = sq_dist(q[:, s:s + step, None, :], base[:, None, :, :])
        v, j = torch.min(d, dim=-1)
        idx.append(j.to(torch.int32))
        d2.append(v)
    return torch.cat(idx, 1), torch.cat(d2, 1)


def nn1(q: torch.Tensor, base: torch.Tensor):
    """Brute 1-NN with a leading pair axis (see nn1_plain). Invalid base
    rows are the caller's to park far away (registration parks them at
    1e9, as the Pallas path does); d2 is the exact difference distance.

    ``nn1_kernel``: a warp carries 8 queries and its lanes stride over the
    base, each lane keeping a running (d2, j) by a strict '<'; a butterfly
    takes the lexicographic (d2, j) minimum over the lanes, which equals the
    sequential scan (ties to the lowest index) bit for bit. One launch."""
    if _on_cpu(q, base):
        return nn1_plain(q, base)
    if q.dim() != 3 or base.dim() != 3 or base.shape[0] != q.shape[0]:
        raise ValueError(f"nn1: expected q [P, Nq, 3], base [P, Nb, 3], got "
                         f"{tuple(q.shape)} and {tuple(base.shape)}")
    p, nq, _ = q.shape
    nb = base.shape[1]
    if nb == 0:
        raise ValueError("nn1: empty base")
    _check(q, "q", torch.float32, (p, nq, 3))
    _check(base, "base", torch.float32, (p, nb, 3))
    idx = torch.empty((p, nq), dtype=torch.int32, device=q.device)
    d2 = torch.empty((p, nq), dtype=torch.float32, device=q.device)
    if p and nq:
        _launch("slscan_nn1", q.device, q.data_ptr(), base.data_ptr(),
                idx.data_ptr(), d2.data_ptr(), p, nq, nb)
        _count(nn1)
    return idx, d2


# K5: ransac_score ------------------------------------------------------------

def ransac_score_plain(hm: torch.Tensor, pm: torch.Tensor, sc: torch.Tensor,
                       md2: float) -> torch.Tensor:
    """hm f32 [T, 16], pm f32 [N, 16], sc f32 [N] (+inf = dead) -> i32 [T]:
    count of n with sc[n] + 2 * sum_c hm[t, c] pm[n, c] <= md2, the dot
    summed c = 0..15 in order."""
    t, n = hm.shape[0], pm.shape[0]
    md2 = torch.tensor(md2, dtype=torch.float32, device=hm.device)
    step = max(1, _ROWS // max(1, n))
    out = []
    for s in range(0, t, step):
        h = hm[s:s + step]
        acc = h[:, 0:1] * pm[None, :, 0]
        for c in range(1, 16):
            acc = acc + h[:, c:c + 1] * pm[None, :, c]
        out.append(((sc[None, :] + 2.0 * acc) <= md2).sum(1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=hm.device)


def ransac_score(hm: torch.Tensor, pm: torch.Tensor, sc: torch.Tensor,
                 md2: float) -> torch.Tensor:
    """Inlier counts i32 [T] of T hypotheses against N correspondences (see
    ransac_score_plain): hm = [R^T t, -R9, -t, t^2/2] and pm = [s, c (x) s,
    c, 1], the centered expansion |R s + t - c|^2 = sc + 2 H.P that
    ``registration._score_args`` builds; sc +inf at dead correspondences.

    ``ransac_score_kernel``: a thread carries 4 hypotheses (four dot chains
    in the plain version's order), the correspondences split over enough
    blocks to fill the card; partial counts meet by integer atomicAdd into
    the output, which the entry zeroes."""
    if _on_cpu(hm, pm, sc):
        return ransac_score_plain(hm, pm, sc, md2)
    t, n = hm.shape[0], pm.shape[0]
    _check(hm, "H", torch.float32, (t, 16))
    _check(pm, "P", torch.float32, (n, 16))
    _check(sc, "sc", torch.float32, (n,))
    if not (t and n):
        return torch.zeros(t, dtype=torch.int32, device=hm.device)
    counts = torch.empty(t, dtype=torch.int32, device=hm.device)
    _launch("slscan_ransac_score", hm.device, hm.data_ptr(), pm.data_ptr(),
            sc.data_ptr(), md2, counts.data_ptr(), t, n)
    _count(ransac_score)
    return counts


# K6, K7: k-NN means ------------------------------------------------------------

# the selection kernels keep a list of 1, 2 or 4 entries a lane (cloud.cu
# kSelMaxSegments); above this k both k-NN means bisect
SELECT_MAX_K = 128


def _knn_mean_rows(d2: torch.Tensor, self_mask: torch.Tensor, k: int, r2b: int):
    """[rows, cands] squared distances -> (mean, count(bits <= r2b)): the
    bisection kernels' statistic, with the k-th smallest bit pattern t taken
    by topk (t = min(k-th, r2b + 1), what 31 bisection passes converge to)."""
    bits = d2.view(torch.int32).masked_fill(self_mask, _SELF_BITS)
    cnt = (bits <= r2b).sum(-1).to(torch.int32)
    if bits.shape[-1] >= k:
        kth = torch.topk(bits, k, dim=-1, largest=False).values[..., -1]
        t = torch.clamp(kth, max=r2b + 1)
    else:
        t = torch.full(bits.shape[:-1], r2b + 1, dtype=torch.int32, device=d2.device)
    lt = bits < t[..., None]
    dist = torch.where(lt, sqrt_f32(d2), torch.zeros((), dtype=torch.float32, device=d2.device))
    c_lt = lt.sum(-1).to(torch.int32)
    tie = (k - c_lt).to(torch.float32) * sqrt_f32(t.view(torch.float32))
    return (dist.sum(-1) + tie) / float(k), cnt


def knn_mean_plain(pts: torch.Tensor, k: int):
    """pts f32 [L, 3] -> (mean f32 [L], cnt i32 [L]): each row's mean
    distance to its k nearest other rows (exact; meaningful where cnt >= k)
    and the count of rows within the 1e17 cutoff (self excluded by index)."""
    n = pts.shape[0]
    step = max(1, _ROWS // max(1, n))
    cols = torch.arange(n, device=pts.device)
    means, cnts = [], []
    for s in range(0, n, step):
        q = pts[s:s + step]
        rows = torch.arange(s, s + q.shape[0], device=pts.device)
        m, c = _knn_mean_rows(sq_dist(q[:, None, :], pts[None, :, :]),
                              rows[:, None] == cols[None, :], k, _KNN_R2_BITS)
        means.append(m)
        cnts.append(c)
    return torch.cat(means), torch.cat(cnts)


def knn_mean(pts: torch.Tensor, k: int):
    """Exact k-NN mean over a whole cloud pts f32 [L, 3], any L (invalid
    rows parked far away by the caller); see knn_mean_plain. Cutoff 1e17.

    Two kernels compute the function, chosen by k alone, as for
    ``slab_mean_knn`` (both are launched and held against the plain version
    on the card; neither falls back to the other):

    - k <= 128 (``SELECT_MAX_K``): ``knn_select_kernel``, one sweep of the
      whole cloud with the slab kernel's warp-level k-selection (a list of
      1, 2 or 4 entries a lane for k <= 32, 64, 128), each block starting
      at its own chunk and wrapping around;
    - k > 128: ``knn_mean_kernel``, 31 bisection sweeps on the f32 bit
      pattern plus a count and a sum sweep.
    """
    if _on_cpu(pts):
        return knn_mean_plain(pts, k)
    if k < 1:
        raise ValueError(f"knn_mean: k must be at least 1, got {k}")
    n = pts.shape[0]
    _check(pts, "pts", torch.float32, (n, 3))
    mean = torch.empty(n, dtype=torch.float32, device=pts.device)
    cnt = torch.empty(n, dtype=torch.int32, device=pts.device)
    if n:
        name = "slscan_knn_mean" if k <= SELECT_MAX_K else "slscan_knn_mean_bisect"
        _launch(name, pts.device, pts.data_ptr(), n, int(k), _KNN_R2_BITS,
                mean.data_ptr(), cnt.data_ptr())
        _count(knn_mean)
    return mean, cnt


def _slab_check(L: int, tile: int, wblk: int) -> None:
    if wblk % tile or L % wblk or L < 2 * wblk:
        raise ValueError(f"slab_mean_knn: need tile | wblk, wblk | L and L >= 2 wblk "
                         f"(L={L}, tile={tile}, wblk={wblk})")


def _slab_starts(pts_sorted: torch.Tensor, r: float, tile: int, wblk: int):
    """Each tile's window start: the sorted slot of its first x - r, aligned
    down to wblk and clamped to leave two blocks."""
    L = pts_sorted.shape[0]
    x = pts_sorted[:, 0].contiguous()
    r32 = torch.tensor(r, dtype=torch.float32, device=x.device)
    a = torch.searchsorted(x, x[::tile] - r32)
    return torch.clamp(a // wblk, max=max(L // wblk - 2, 0)) * wblk


def slab_mean_knn_plain(pts_sorted: torch.Tensor, r: float, k: int, tile: int,
                        wblk: int):
    """pts_sorted f32 [L, 3], ascending x (invalid rows parked at a far
    sentinel) -> (mean f32 [L], cnt i32 [L] of candidates within r, win_end
    i32 [L]): each row against the 2*wblk window of its tile."""
    L = pts_sorted.shape[0]
    _slab_check(L, tile, wblk)
    r2b = _sq_bits(r)
    starts = _slab_starts(pts_sorted, r, tile, wblk)
    w = 2 * wblk
    span = torch.arange(w, device=pts_sorted.device)
    tiles_per = max(1, _ROWS // (tile * w))
    means, cnts = [], []
    for s in range(0, L // tile, tiles_per):
        c0 = starts[s:s + tiles_per]
        cand_idx = c0[:, None] + span[None, :]                      # [nt, w]
        cand = pts_sorted[cand_idx]                                 # [nt, w, 3]
        q = pts_sorted[s * tile:(s + c0.shape[0]) * tile].view(-1, tile, 3)
        qg = torch.arange(s * tile, (s + c0.shape[0]) * tile,
                          device=pts_sorted.device).view(-1, tile)
        m, c = _knn_mean_rows(sq_dist(q[:, :, None, :], cand[:, None, :, :]),
                              qg[:, :, None] == cand_idx[:, None, :], k, r2b)
        means.append(m.reshape(-1))
        cnts.append(c.reshape(-1))
    win_end = torch.repeat_interleave(starts + w, tile).to(torch.int32)
    return torch.cat(means), torch.cat(cnts), win_end


def slab_mean_knn(pts_sorted: torch.Tensor, r: float, k: int, tile: int = 64,
                  wblk: int = 8192):
    """Slab-window mean of the k nearest neighbours (see
    slab_mean_knn_plain). The kernels take 64 queries a block, so they need
    tile % 64 == 0.

    Two kernels compute the function, chosen by k (both are launched and
    held against the plain version on the card):

    - k <= 128 (``SELECT_MAX_K``): ``slab_select_kernel``, one sweep of
      the window that computes each (query, candidate) d2 once and keeps the
      k smallest in a sorted list of E entries a lane, E = 1, 2, 4 for
      k <= 32, 64, 128 (a warp-level k-selection); the pipeline's k is 20.
    - k > 128: ``slab_knn_mean_kernel``, 31 bisection sweeps on the f32 bit
      pattern plus a count and a sum sweep (the routine ``knn_mean`` runs).
    """
    if _on_cpu(pts_sorted):
        return slab_mean_knn_plain(pts_sorted, r, k, tile, wblk)
    L = pts_sorted.shape[0]
    _slab_check(L, tile, wblk)
    if tile % 64:
        raise ValueError(f"slab_mean_knn: the kernel needs tile % 64 == 0, got {tile}")
    if k < 1:
        raise ValueError(f"slab_mean_knn: k must be at least 1, got {k}")
    _check(pts_sorted, "pts_sorted", torch.float32, (L, 3))
    dev = pts_sorted.device
    mean = torch.empty(L, dtype=torch.float32, device=dev)
    cnt = torch.empty(L, dtype=torch.int32, device=dev)
    win_end = torch.empty(L, dtype=torch.int32, device=dev)
    name = ("slscan_slab_mean_knn" if k <= SELECT_MAX_K
            else "slscan_slab_mean_knn_bisect")
    _launch(name, dev, pts_sorted.data_ptr(), L, int(k), _sq_bits(r),
            int(wblk), int(tile), float(torch.tensor(r, dtype=torch.float32)),
            mean.data_ptr(), cnt.data_ptr(), win_end.data_ptr())
    _count(slab_mean_knn)
    return mean, cnt, win_end


# K8: radius_count --------------------------------------------------------------

def radius_count_plain(pts: torch.Tensor, r: float) -> torch.Tensor:
    """pts f32 [N, 3] -> i32 [N]: per row, the rows j != i with
    ((dx*dx + dy*dy) + dz*dz) <= f32(r)^2, the kernel's float order."""
    n = pts.shape[0]
    r2 = _sq_f32(r).to(pts.device)
    step = max(1, _ROWS // max(1, n))
    cols = torch.arange(n, device=pts.device)
    out = []
    for s in range(0, n, step):
        q = pts[s:s + step]
        rows = torch.arange(s, s + q.shape[0], device=pts.device)
        within = (sq_dist(q[:, None, :], pts[None, :, :]) <= r2) & (rows[:, None] != cols[None, :])
        out.append(within.sum(1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=pts.device)


def radius_count(pts: torch.Tensor, r: float) -> torch.Tensor:
    """Neighbours within ``r`` of every row of pts f32 [N, 3], self excluded
    by index (see radius_count_plain). Invalid rows are the caller's to park
    far away (``knn.FAR``): a parked row is no valid row's neighbour.

    Replaces ``_radius_kernel`` (pallas_kernels.py, ``_radius_call``):
    bound by operations, 9 a (query, base) pair (3 sub, 3 mul, 2 add, 1
    compare), N^2 pairs. The kernel counts every base row and subtracts the
    query's own term, carries 8 queries a thread and splits the base across
    grid.y; partial counts meet by integer atomicAdd into a zeroed output,
    so the counts are exact in any order."""
    if _on_cpu(pts):
        return radius_count_plain(pts, r)
    n = pts.shape[0]
    _check(pts, "pts", torch.float32, (n, 3))
    counts = torch.empty(n, dtype=torch.int32, device=pts.device)
    if n:
        _launch("slscan_radius_count", pts.device, pts.data_ptr(), n,
                float(_sq_f32(r)), counts.data_ptr())
        _count(radius_count)
    return counts


# K9: knn_binmin ----------------------------------------------------------------

BINMIN_MIN_BINS = 128     # XLA's ApproxTopK floor on its bin count (the TPU's tiling)
_BINMIN_MAX_N = 1 << 25   # the entry's limit: column indices stay below 2^31
_ROWS_CUDA = 1 << 26      # elements a chunk of knn_binmin_plain on the card
# The tensor-core screen's margin (csrc/cloud.cu's note derives it):
# |d2 - d2~| <= BINMIN_ALPHA * (|q'|^2 + |c'|^2) + BINMIN_BETA for every pair,
# q' and c' centred on binmin_screen_terms' centroid.
BINMIN_ALPHA = 2.0 ** -12
BINMIN_BETA = 2.0 ** -60
# The tensor cores' error in summing a tile's 16 bf16 products and its f32
# accumulator, of the sum's absolute terms, that the margin's derivation
# takes (csrc/cloud.cu's note); chip_smoke.py measures it on the card with
# binmin_mma_probe and fails above it.
BINMIN_ACC = 2.0 ** -20
_BINMIN_HUGE = 2.0 ** 60  # a finite coordinate beyond this: every row takes the exact sweep
_BINMIN_ROUTE = 16.0      # rows beyond 4x the unparked cloud's radius take the exact sweep


def binmin_screen_terms(pts: torch.Tensor) -> torch.Tensor:
    """The data terms of knn_binmin's screen, [mu_x, mu_y, mu_z, route_r2]
    f32 on pts' device (no host sync): mu, the centroid of the unparked
    points (every coordinate finite and below FAR / 2), on which the screen
    centres rows and columns; route_r2, 16x the largest squared distance of
    an unparked point from mu, rounded up to f32: a query row farther than
    that from mu (a parked row, a non-finite row) takes the kernel's exact
    sweep, since the margin (``binmin_margin``) grows with |q'|^2 and could
    not narrow its bins. route_r2 is -1 (every row exact) where no point is
    unparked or a finite coordinate exceeds 2^60, beyond which the screen's
    f32 norms could overflow."""
    p = pts.detach().to(torch.float32)
    a = p.abs()
    near = (a < FAR / 2).all(1)
    pn = torch.where(near[:, None], p, 0.0)
    cnt = near.sum()
    mu = (pn.sum(0, dtype=torch.float64) / cnt.clamp(min=1)).float()
    r2 = torch.where(near, ((pn - mu) ** 2).sum(1), 0.0).amax() if len(p) else p.new_zeros(())
    route = _f32_up(_BINMIN_ROUTE * r2.double())
    skip = ((a > _BINMIN_HUGE) & (a < math.inf)).any() | (cnt == 0)
    return torch.cat([mu, torch.where(skip, -1.0, route)[None]])


def _f32_up(v: torch.Tensor) -> torch.Tensor:
    """The least f32 values >= the float64 values v."""
    f = v.float()
    return torch.where(f.double() < v, torch.nextafter(f, f.new_tensor(math.inf)), f)


def binmin_margin(qn2, cn2):
    """The screen's bound on |d2 - d2~| for a pair with centred squared norms
    |q'|^2 = qn2 and |c'|^2 = cn2 (numbers or arrays)."""
    return BINMIN_ALPHA * (qn2 + cn2) + BINMIN_BETA


_stats: dict[torch.device, torch.Tensor] = {}


def _binmin_stats_buffer(device: torch.device) -> torch.Tensor:
    with _COUNT_LOCK:
        buf = _stats.get(device)
        if buf is None:
            buf = _stats[device] = torch.zeros(4, dtype=torch.int64, device=device)
        return buf


def binmin_stats() -> dict[str, int]:
    """What the knn_binmin kernel's launches in this process did, summed
    over devices (a caller takes the difference of two readings): query rows
    screened on the tensor cores, rows sent to the exact sweep, (row, column)
    pairs confirmed exactly, pairs the exact sweep evaluated. One host sync a
    device."""
    with _COUNT_LOCK:
        bufs = list(_stats.values())
    tot = [0, 0, 0, 0]
    for buf in bufs:
        tot = [a + b for a, b in zip(tot, buf.tolist())]
    return dict(zip(("screened_rows", "exact_rows", "confirms", "exact_pairs"), tot))


def binmin_bins(n: int, k: int, recall: float) -> int:
    """M, the bin count of the binned selection of the k nearest among n
    columns at per-row ``recall``: the recall model of XLA's ApproxTopK,
    (1 - 1/M)^(k-1) ~ exp(-(k-1)/M) = recall, so m = (k - 1) / -ln(recall),
    rounded up to a power of two, at least BINMIN_MIN_BINS and k, and capped
    at n. It depends on (k, recall) alone below the cap, so a cloud padded
    with parked rows gets the bins of the same cloud unpadded wherever they
    differ at all: with n <= M every column is its own bin and the selection
    is exact, as it is at recall 1.0."""
    if not 0.0 < recall <= 1.0:
        raise ValueError(f"recall must lie in (0, 1], got {recall}")
    if recall == 1.0:
        return n
    m = max((k - 1) / -math.log(recall), float(BINMIN_MIN_BINS), float(k))
    return min(1 << math.ceil(math.log2(m)), n)


def bin_minima(d2: torch.Tensor, m: int):
    """[rows, N] distances -> (d2 f32 [rows, M], idx i32 [rows, M]): for
    each bin b, the least value over the columns b, b + M, b + 2M, ... and
    its column, the lowest on ties (+inf at column b where none is finite).
    A running minimum by a strict '<' over the column blocks in rising
    order, the kernel's own rule."""
    ar = torch.arange(m, dtype=torch.int32, device=d2.device)
    best = d2[:, :m].clone()
    idx = ar.expand(d2.shape[0], m).clone()
    for s in range(m, d2.shape[1], m):
        blk = d2[:, s:s + m]
        w = blk.shape[1]
        better = blk < best[:, :w]
        best[:, :w] = torch.where(better, blk, best[:, :w])
        idx[:, :w] = torch.where(better, ar[:w] + s, idx[:, :w])
    return best, idx


def knn_binmin_plain(pts: torch.Tensor, rows: torch.Tensor, m: int,
                     exclude_self: bool = True):
    """pts f32 [N, 3] (invalid rows parked far away), rows i32 [R] in [0, N)
    -> (d2 f32 [R, M], idx i32 [R, M]): for each query row and bin b < M, the
    least ((dx*dx + dy*dy) + dz*dz) over the columns j = b, b + M, ... (j !=
    the row where ``exclude_self``: its d2 is +inf) and its column, the
    lowest on ties; (+inf, b) where no column of the bin is finite."""
    n = pts.shape[0]
    cols = torch.arange(n, device=pts.device)
    step = max(1, (_ROWS_CUDA if pts.is_cuda else _ROWS) // max(1, n))
    d2s, idxs = [], []
    for s in range(0, rows.shape[0], step):
        rr = rows[s:s + step].long()
        d2 = sq_dist(pts[rr][:, None, :], pts[None, :, :])
        if exclude_self:
            d2.masked_fill_(rr[:, None] == cols[None, :], float("inf"))
        d, i = bin_minima(d2, m)
        d2s.append(d)
        idxs.append(i)
    if not d2s:
        return (torch.zeros((0, m), dtype=torch.float32, device=pts.device),
                torch.zeros((0, m), dtype=torch.int32, device=pts.device))
    return torch.cat(d2s), torch.cat(idxs)


def knn_binmin(pts: torch.Tensor, rows: torch.Tensor, m: int, exclude_self: bool = True,
               terms: torch.Tensor | None = None):
    """Each bin's nearest column for the query rows (see knn_binmin_plain):
    the partial reduce of a binned k-NN selection; a top-k over the M
    winners of a row (``knn._knn_binned``) is the selection.

    No Pallas original: the JAX package selects with XLA's
    ``lax.approx_min_k`` outside any Pallas kernel (ops/knn.py:188, 260;
    ops/pointcloud.py:418), the TPU's PartialReduce beside distances taken
    on its matrix unit. ``knn_binmin_kernel`` screens on the tensor cores
    and confirms on the CUDA cores (csrc/cloud.cu's note): a prep pass
    writes each column's bf16 hi + lo record centred on
    ``binmin_screen_terms``' centroid; pass 1 takes each (row, bin)'s least
    upper bound d2~ + margin by mma.sync, pass 2 sends the columns whose
    lower bound d2~ - margin reaches it to the exact difference d2, kept by
    the lexicographic least (d2, j); rows the screen cannot narrow (parked,
    non-finite) take an exact sweep that stops at d2 = 0. The result equals
    the plain version bit for bit. Bound by the screen's CUDA-core
    instructions (2.25 a (row, column) pair at least) and the tensor cores'
    bf16 rate (two m16n8k16 a 128 pairs). ``terms`` is
    ``binmin_screen_terms(pts)``, computed here where it is None: its
    reductions over the cloud cost about a millisecond a call on the card
    (``terms_ms``, chip_smoke.py phase 15(a)), so a caller that splits one
    cloud's rows into chunks (``knn._knn_binned``) computes it once. One
    launch of the entry (the prep pass and the kernel); the check of the
    row indices is the one host sync. The counts of what it did add up in
    ``binmin_stats``."""
    if _on_cpu(pts, rows):
        return knn_binmin_plain(pts, rows, m, exclude_self)
    n, r = pts.shape[0], rows.shape[0]
    _check(pts, "pts", torch.float32, (n, 3))
    _check(rows, "rows", torch.int32, (r,))
    if not 1 <= m <= n or n > _BINMIN_MAX_N:
        raise ValueError(f"knn_binmin: M = {m} bins over N = {n} columns is outside "
                         f"1 <= M <= N <= {_BINMIN_MAX_N}")
    d2 = torch.empty((r, m), dtype=torch.float32, device=pts.device)
    idx = torch.empty((r, m), dtype=torch.int32, device=pts.device)
    if r:
        lo, hi = (int(v) for v in torch.aminmax(rows))
        if lo < 0 or hi >= n:
            raise IndexError(f"knn_binmin: query rows span [{lo}, {hi}], outside [0, {n})")
        if terms is None:
            terms = binmin_screen_terms(pts)
        _check(terms, "terms", torch.float32, (4,))
        if terms.device != pts.device:
            raise ValueError(f"terms on {terms.device}, points on {pts.device}")
        op = torch.empty((n, 8), dtype=torch.int32, device=pts.device)    # 32-byte records
        raw = torch.empty((n, 4), dtype=torch.float32, device=pts.device)  # 16-byte rows
        _launch("slscan_knn_binmin", pts.device, pts.data_ptr(), rows.data_ptr(), r, n,
                int(m), int(bool(exclude_self)), terms.data_ptr(), BINMIN_ALPHA, BINMIN_BETA,
                op.data_ptr(), raw.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                _binmin_stats_buffer(pts.device).data_ptr())
        _count(knn_binmin)
    return d2, idx


def binmin_mma_probe(a: torch.Tensor, bt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """d = a bt^T + c over tiles, by the mma.sync.m16n8k16 (bf16 products,
    f32 accumulation) of knn_binmin's screen: a [T, 16, 16] and bt [T, 8,
    16] bfloat16 (bt: each of the 8 columns' 16 K values in a row), c [T,
    16, 8] f32 -> d [T, 16, 8] f32. No kernel of a path: it measures the
    tensor cores' accumulation error, which the screen's margin takes as
    BINMIN_ACC (chip_smoke.py). On the CPU the plain version: the sum in
    float64, rounded once to f32."""
    if _on_cpu(a, bt, c):
        return (torch.einsum("tmk,tnk->tmn", a.double(), bt.double()) + c.double()).float()
    t = a.shape[0]
    _check(a, "a", torch.bfloat16, (t, 16, 16))
    _check(bt, "bt", torch.bfloat16, (t, 8, 16))
    _check(c, "c", torch.float32, (t, 16, 8))
    d = torch.empty((t, 16, 8), dtype=torch.float32, device=a.device)
    if t:
        _launch("slscan_bm_mma_probe", a.device, a.data_ptr(), bt.data_ptr(), c.data_ptr(),
                d.data_ptr(), t)
    return d


KERNELS = (decode_maps, decode_packed_maps, scan_fused, nn1, ransac_score,
           knn_mean, slab_mean_knn, radius_count, knn_binmin)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
