"""Kernel wrappers of the scan path, their plain versions, and launch counts.

The counterpart of the JAX package's ``ops/pallas_kernels.py`` for the three
kernel families on the scan path, each a CUDA C++ kernel in
``csrc/decode.cu``:

  decode_maps         Gray decode of raw frames      (_decode_kernel[_views])
  decode_packed_maps  Gray decode of packed bits     (_decode_packed_kernel[_views])
  scan_fused          decode + quadratic triangulate (_scan_fused_kernel)

Every wrapper takes a leading view axis V. For tensors on the CPU it runs
its plain PyTorch version (``*_plain``, the same function written with
tensor ops, mirroring the Pallas tile math). For CUDA tensors it checks
device, dtype, shape and contiguity, allocates the outputs, launches the
kernel on the current stream and raises on a non-zero CUDA error — there
is no fallback. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import _build

__all__ = ["decode_maps", "decode_maps_plain", "decode_packed_maps",
           "decode_packed_maps_plain", "scan_fused", "scan_fused_plain",
           "scan_scalars", "sqrt_f32", "KERNELS", "launch_counts", "reset_launch_counts"]

# ---------------------------------------------------------------------------
# the C interface (csrc/decode.cu)
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "slscan_decode_maps": [_P] * 5 + [_I, _I, _L] + [_I] * 8 + [_P],
    "slscan_decode_packed_maps": [_P] * 7 + [_I, _I, _L] + [_I] * 8 + [_P],
    "slscan_scan_fused": [_P] * 7 + [_I, _I, _L] + [_I] * 9 + [_P],
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


def _launch(name: str, device: torch.device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
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
    decode_maps.launches += 1
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
    decode_packed_maps.launches += 1
    return col, row, mask


# ---------------------------------------------------------------------------
# K3: scan_fused
# ---------------------------------------------------------------------------

def scan_scalars(oc: torch.Tensor, poly_col: torch.Tensor,
                 poly_row: torch.Tensor, epipolar_tol: float) -> torch.Tensor:
    """The fused kernel's f32[32] scalars on ``oc``'s device: oc xyz @0..2,
    epipolar tolerance @3, column-plane quadratic @4..15, row-plane
    quadratic @16..27 (each [3, 4] row-major: rows A, B, C of (nx, ny, nz, d))."""
    f32 = torch.float32
    return torch.cat([oc.reshape(3).to(f32),
                      oc.new_tensor([epipolar_tol], dtype=f32),
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
    the full sequence: F >= 2 + 2 * (n_bits_col + n_bits_row)."""
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
    scan_fused.launches += 1
    return pts, valid, tex


KERNELS = (decode_maps, decode_packed_maps, scan_fused)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
