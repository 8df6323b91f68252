"""Gray-code pattern generation, Otsu thresholds and per-pixel decode.

Pattern order (the capture-file contract): frame 0 white, frame 1 black,
then for each column bit MSB -> LSB a (pattern, inverse) pair, then each
row bit. Decode reads the first ``n_sets`` bit pairs of each axis, inverts
the reflected Gray code, and scales by 2^(n_bits - n_use) so coordinates
stay full-range; patterns projected with downsample k decode in the
k-decimated raster and scale by k.

The decode itself is a kernel (``ops/kernels.decode_maps`` for raw frames,
``decode_packed_maps`` for packed bit-planes): CUDA on a CUDA tensor, the
plain PyTorch version on a CPU tensor. Otsu histograms are built with
``torch.bincount`` on the frames' device and scored on the host in float64,
so every backend picks the same bin.

``decode_stack_np`` is the all-host decode of the ``parallel.backend =
'numpy'`` reference path: the JAX package's NumPy arithmetic, bit-equal to
its ``decode_stack_np`` (and to the decode kernel). ``decode_packed_np`` is
its twin on packed bit-planes, and ``otsu_threshold_np`` the host Otsu.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.utils.device import (
    resolve_device,
)

__all__ = ["gray_bits", "generate_pattern_stack", "frames_per_view",
           "otsu_threshold", "otsu_threshold_np", "resolve_thresholds",
           "resolve_thresholds_views", "decode_stack", "decode_packed",
           "decode_stack_np", "decode_packed_np", "DecodeResult"]


def _n_bits(size: int) -> int:
    return max(1, int(np.ceil(np.log2(size))))


def gray_bits(size: int, n_bits: int | None = None) -> np.ndarray:
    """Bit-planes of the reflected Gray code gray(x) = x ^ (x >> 1) for
    positions [0, size): bool [n_bits, size], MSB first."""
    if n_bits is None:
        n_bits = _n_bits(size)
    x = np.arange(size, dtype=np.int64)
    g = x ^ (x >> 1)
    shifts = np.arange(n_bits - 1, -1, -1, dtype=np.int64)
    return ((g[None, :] >> shifts[:, None]) & 1).astype(bool)


def frames_per_view(width: int = 1920, height: int = 1080, downsample: int = 1) -> int:
    """Frames of one capture sequence: 2 + 2*(bits(w//k) + bits(h//k));
    46 at 1920x1080."""
    return 2 + 2 * (_n_bits(width // downsample) + _n_bits(height // downsample))


def generate_pattern_stack(width: int = 1920, height: int = 1080,
                           brightness: int = 200, downsample: int = 1) -> np.ndarray:
    """The projector frame sequence as uint8 [F, height, width] (numpy).
    With downsample k the stripes are computed at (width//k, height//k) and
    nearest-upsampled to the full projector raster."""
    w, h = width // downsample, height // downsample
    nc, nr = _n_bits(w), _n_bits(h)
    col = gray_bits(w, nc)
    row = gray_bits(h, nr)
    frames = np.zeros((2 + 2 * (nc + nr), h, w), dtype=np.uint8)
    frames[0] = brightness
    f = 2
    for b in range(nc):
        stripe = np.where(col[b], brightness, 0).astype(np.uint8)
        frames[f] = np.broadcast_to(stripe, (h, w))
        frames[f + 1] = brightness - frames[f]
        f += 2
    for b in range(nr):
        stripe = np.where(row[b], brightness, 0).astype(np.uint8)
        frames[f] = np.broadcast_to(stripe[:, None], (h, w))
        frames[f + 1] = brightness - frames[f]
        f += 2
    if downsample > 1:
        xi = (np.arange(width) * w) // width
        yi = (np.arange(height) * h) // height
        frames = frames[:, yi[:, None], xi[None, :]]
    return frames


# ---------------------------------------------------------------------------
# Otsu threshold: histogram argmax of the between-class variance, scored in
# float64 on the host (first maximum wins; empty classes score 0 — OpenCV's
# rule)
# ---------------------------------------------------------------------------

def _otsu_from_hist(counts: np.ndarray) -> int:
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    levels = np.arange(256, dtype=np.float64)
    w1 = np.cumsum(counts)
    m1 = np.cumsum(counts * levels)
    mT = m1[-1]
    w2 = total - w1
    num = (mT * w1 - total * m1) ** 2
    den = w1 * w2
    sigma_b = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    return int(np.argmax(sigma_b))


def _hists(img_v: torch.Tensor) -> np.ndarray:
    """256-bin histogram of each view of a u8 [V, ...] tensor, built on its
    device in one bincount and fetched once -> int64 [V, 256]."""
    v = img_v.shape[0]
    offs = torch.arange(v, device=img_v.device, dtype=torch.int64) * 256
    idx = img_v.reshape(v, -1).to(torch.int64) + offs[:, None]
    return torch.bincount(idx.reshape(-1), minlength=256 * v).reshape(v, 256).cpu().numpy()


def _white_diff_u8(frames_v: torch.Tensor):
    """White frame and the white-black difference clipped to [0, 255], u8."""
    white = frames_v[:, 0]
    diff = (white.to(torch.float32) - frames_v[:, 1].to(torch.float32)).clamp(0, 255)
    return white.to(torch.uint8), diff.to(torch.uint8)


def otsu_threshold(img_u8: torch.Tensor) -> int:
    """Otsu threshold of one uint8 image."""
    return _otsu_from_hist(_hists(img_u8[None])[0])


def otsu_threshold_np(img_u8: np.ndarray) -> int:
    """Otsu threshold of one uint8 image on the host (numpy)."""
    return _otsu_from_hist(np.bincount(np.asarray(img_u8).reshape(-1), minlength=256)[:256])


def resolve_thresholds_views(frames_v: torch.Tensor, thresh_mode: str,
                             shadow_val: float, contrast_val: float
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Per-view (shadow, contrast) thresholds, f32 [V] each, of a
    [V, F, H, W] stack (only frames 0 and 1 are read). ``otsu`` scores the
    histograms of the white frame and the clipped white-black difference;
    any other mode returns the manual values."""
    v = frames_v.shape[0]
    if thresh_mode != "otsu":
        return (np.full(v, shadow_val, np.float32),
                np.full(v, contrast_val, np.float32))
    white, diff = _white_diff_u8(frames_v)
    h_w, h_d = _hists(white), _hists(diff)
    return (np.array([_otsu_from_hist(h) for h in h_w], np.float32),
            np.array([_otsu_from_hist(h) for h in h_d], np.float32))


def resolve_thresholds(frames: torch.Tensor, thresh_mode: str, shadow_val: float,
                       contrast_val: float) -> tuple[float, float]:
    """(shadow, contrast) of one [F, H, W] stack, as Python floats."""
    ss, cs = resolve_thresholds_views(frames[None], thresh_mode, shadow_val,
                                      contrast_val)
    return float(ss[0]), float(cs[0])


def threshold_tensor(ss: np.ndarray, cs: np.ndarray,
                     device: torch.device) -> torch.Tensor:
    """The kernels' f32 [V, 2] (shadow, contrast) tensor on ``device``. A
    card gets it from pinned memory by a copy queued on its current stream:
    a copy from pageable memory would make the host wait for the stream."""
    thr = torch.from_numpy(np.stack([np.asarray(ss, np.float32),
                                     np.asarray(cs, np.float32)], 1))
    if torch.device(device).type == "cuda":
        return thr.pin_memory().to(device, non_blocking=True)
    return thr.to(device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeResult(NamedTuple):
    """Per-pixel decode output; invalid pixels carry mask=False."""

    col_map: torch.Tensor  # int32 [..., H, W], projector column
    row_map: torch.Tensor  # int32 [..., H, W], projector row
    mask: torch.Tensor     # bool  [..., H, W], shadow & contrast valid
    texture: torch.Tensor  # uint8 [H, W, 3] (or [H, W, 1] gray)


class DecodePlan(NamedTuple):
    n_bits_col: int
    n_bits_row: int
    n_use_col: int
    n_use_row: int
    downsample: int


def decode_plan(n_frames: int, *, n_cols: int, n_rows: int, n_sets_col: int,
                n_sets_row: int, downsample: int,
                skip_remaining_before_row: bool = False) -> DecodePlan:
    """Bit counts of one decode. A stack shorter than the full sequence
    raises unless ``skip_remaining_before_row`` (the legacy truncated-stack
    decode: missing pairs decode as 0 in the low bits)."""
    n_cols //= downsample
    n_rows //= downsample
    nbc, nbr = _n_bits(n_cols), _n_bits(n_rows)
    need = 2 + 2 * (nbc + nbr)
    if n_frames < need and not skip_remaining_before_row:
        raise ValueError(
            f"Not enough frames: got {n_frames}, need {need} "
            f"(white + black + 2*({nbc} col + {nbr} row bit-planes)) "
            f"for a {n_cols}x{n_rows} projector. Pass "
            f"skip_remaining_before_row=True for the legacy truncated-stack "
            f"decode.")
    return DecodePlan(nbc, nbr, max(1, min(int(n_sets_col), nbc)),
                      max(1, min(int(n_sets_row), nbr)), int(downsample))


def decode_views(frames_v: torch.Tensor, thr_v: torch.Tensor, plan: DecodePlan):
    """(col, row, mask) [V, H, W] of a [V, F, H, W] stack with thresholds
    [V, 2], through the decode kernel."""
    return kernels.decode_maps(frames_v, thr_v, **plan._asdict())


def decode_packed_views(planes_v, white_v, black_v, thr_v, n_frames: int,
                        plan: DecodePlan):
    """(col, row, mask) [V, H, W] of packed stacks, through the packed
    decode kernel."""
    return kernels.decode_packed_maps(planes_v, white_v, black_v, thr_v,
                                      n_pairs=(n_frames - 2) // 2,
                                      **plan._asdict())


def _tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` is given; anything else
    goes to ``device`` (None -> cuda)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def decode_stack(frames, texture=None, *, n_cols: int = 1920,
                 n_rows: int = 1080, n_sets_col: int = 11, n_sets_row: int = 11,
                 thresh_mode: str = "otsu", shadow_val: float = 40.0,
                 contrast_val: float = 10.0, downsample: int = 1,
                 skip_remaining_before_row: bool = False,
                 device=None) -> DecodeResult:
    """Decode a [F, H, W] capture stack (numpy or tensor).

    ``thresh_mode``: ``"otsu"`` (histograms on the device, scored on the
    host in float64; ``"otsu_device"`` is taken as ``"otsu"``) or
    ``"manual"`` (``shadow_val`` / ``contrast_val`` as given).
    """
    frames = _tensor(frames, device)
    if texture is None:
        texture = frames[0, ..., None].expand(*frames.shape[1:], 3).to(torch.uint8)
    else:
        texture = _tensor(texture, frames.device)
    mode = "otsu" if thresh_mode == "otsu_device" else thresh_mode
    ss, cs = resolve_thresholds_views(frames[None], mode, shadow_val, contrast_val)
    plan = decode_plan(frames.shape[0], n_cols=n_cols, n_rows=n_rows,
                       n_sets_col=n_sets_col, n_sets_row=n_sets_row,
                       downsample=downsample,
                       skip_remaining_before_row=skip_remaining_before_row)
    col, row, mask = decode_views(frames[None].contiguous(),
                                  threshold_tensor(ss, cs, frames.device), plan)
    return DecodeResult(col[0], row[0], mask[0], texture)


def decode_packed(planes, white, black, texture=None, *, n_frames: int,
                  n_cols: int = 1920, n_rows: int = 1080, n_sets_col: int = 11,
                  n_sets_row: int = 11, thresh_mode: str = "otsu",
                  shadow_val: float = 40.0, contrast_val: float = 10.0,
                  downsample: int = 1, skip_remaining_before_row: bool = False,
                  device=None) -> DecodeResult:
    """Decode a packed bit-plane stack (``io.images.pack_stack`` layout) —
    bit-identical to ``decode_stack`` on the raw stack it was packed from:
    thresholds and mask read only the verbatim white/black frames, and the
    stored bits are the comparisons decode computes."""
    planes = _tensor(planes, device)
    white = _tensor(white, planes.device)
    black = _tensor(black, planes.device)
    if texture is None:
        texture = white[..., None].expand(*white.shape, 3).to(torch.uint8)
    else:
        texture = _tensor(texture, planes.device)
    mode = "otsu" if thresh_mode == "otsu_device" else thresh_mode
    wb = torch.stack([white, black])[None]
    ss, cs = resolve_thresholds_views(wb, mode, shadow_val, contrast_val)
    plan = decode_plan(n_frames, n_cols=n_cols, n_rows=n_rows,
                       n_sets_col=n_sets_col, n_sets_row=n_sets_row,
                       downsample=downsample,
                       skip_remaining_before_row=skip_remaining_before_row)
    col, row, mask = decode_packed_views(
        planes[None].contiguous(), white[None].contiguous(),
        black[None].contiguous(), threshold_tensor(ss, cs, planes.device),
        n_frames, plan)
    return DecodeResult(col[0], row[0], mask[0], texture)


# ---------------------------------------------------------------------------
# The NumPy reference decode (the numpy backend), the JAX package's
# arithmetic op for op
# ---------------------------------------------------------------------------

def _gray_to_binary_np(g: np.ndarray) -> np.ndarray:
    g = g ^ (g >> 1)
    g = g ^ (g >> 2)
    g = g ^ (g >> 4)
    g = g ^ (g >> 8)
    return g


def _decode_axis_np(fr, start: int, max_bits: int, n_use: int, n_frames=None):
    """One axis from the (pattern, inverse) pairs at fr[start:]: the first
    ``n_use`` bit pairs, MSB first, Gray -> binary, scaled to full range;
    pairs past the end of a truncated stack (``n_frames``) read as 0."""
    avail = n_use if n_frames is None else max(0, min(n_use, (n_frames - start) // 2))
    pat = fr[start:start + 2 * avail:2]
    inv = fr[start + 1:start + 2 * avail:2]
    bits = (pat > inv).astype(np.int32)
    weights = (1 << np.arange(n_use - 1, n_use - 1 - avail, -1, dtype=np.int32))
    if avail == 0:
        gray = np.zeros(fr.shape[1:], np.int32)
    else:
        gray = np.sum(bits * weights[:, None, None], axis=0)
    return _gray_to_binary_np(gray) * (1 << (max_bits - n_use))


def _resolve_thresholds_np(frames: np.ndarray, thresh_mode: str, shadow_val: float,
                           contrast_val: float) -> tuple[float, float]:
    """(shadow, contrast): Otsu of the white frame and of the clipped
    white - black difference in ``otsu`` mode, else the manual values (as
    the JAX package's NumPy path, ``otsu_device`` reads as manual here)."""
    if thresh_mode != "otsu":
        return float(shadow_val), float(contrast_val)
    white = frames[0]
    diff = np.clip(white.astype(np.float32) - frames[1].astype(np.float32),
                   0, 255).astype(np.uint8)
    h_w = np.bincount(white.astype(np.uint8).reshape(-1), minlength=256)[:256]
    h_d = np.bincount(diff.reshape(-1), minlength=256)[:256]
    return float(_otsu_from_hist(h_w)), float(_otsu_from_hist(h_d))


def decode_stack_np(frames: np.ndarray, texture: np.ndarray | None = None, *,
                    n_cols: int = 1920, n_rows: int = 1080, n_sets_col: int = 11,
                    n_sets_row: int = 11, thresh_mode: str = "otsu",
                    shadow_val: float = 40.0, contrast_val: float = 10.0,
                    downsample: int = 1,
                    skip_remaining_before_row: bool = False) -> DecodeResult:
    """Decode a [F, H, W] capture stack on the host (numpy arrays in and
    out): the reference decode of the numpy backend."""
    if texture is None:
        texture = np.repeat(frames[0][..., None], 3, axis=-1).astype(np.uint8)
    shadow, contrast = _resolve_thresholds_np(frames, thresh_mode, shadow_val,
                                              contrast_val)
    plan = decode_plan(frames.shape[0], n_cols=n_cols, n_rows=n_rows,
                       n_sets_col=n_sets_col, n_sets_row=n_sets_row,
                       downsample=downsample,
                       skip_remaining_before_row=skip_remaining_before_row)
    need = 2 + 2 * (plan.n_bits_col + plan.n_bits_row)
    n_frames = frames.shape[0] if frames.shape[0] < need else None
    fr = frames.astype(np.int16)
    white, black = fr[0], fr[1]
    mask = (white > shadow) & ((white - black) > contrast)
    col_map = _decode_axis_np(fr, 2, plan.n_bits_col, plan.n_use_col,
                              n_frames) * downsample
    row_map = _decode_axis_np(fr, 2 + 2 * plan.n_bits_col, plan.n_bits_row,
                              plan.n_use_row, n_frames) * downsample
    return DecodeResult(col_map.astype(np.int32), row_map.astype(np.int32), mask,
                        texture)


def _decode_axis_packed_np(planes, pair_start: int, max_bits: int, n_use: int,
                           n_pairs=None):
    """``_decode_axis_np`` on packed bit-planes: pair p's comparison bit is
    bit p%8 of plane byte p//8, so the axis is a shift-and-mask of the
    planes feeding the same weights, Gray -> binary and rescale.
    ``pair_start`` counts pairs (frame 2 + 2 * pair_start); pairs past
    ``n_pairs`` (a truncated stack) read as 0."""
    avail = n_use if n_pairs is None else max(0, min(n_use, n_pairs - pair_start))
    if avail == 0:
        gray = np.zeros(planes.shape[1:], np.int32)
    else:
        p = np.arange(pair_start, pair_start + avail)
        shifts = (p & 7).astype(np.uint8)[:, None, None]
        bits = ((planes[p >> 3] >> shifts) & 1).astype(np.int32)
        weights = (1 << np.arange(n_use - 1, n_use - 1 - avail, -1, dtype=np.int32))
        gray = np.sum(bits * weights[:, None, None], axis=0)
    return _gray_to_binary_np(gray) * (1 << (max_bits - n_use))


def decode_packed_np(planes: np.ndarray, white: np.ndarray, black: np.ndarray,
                     texture: np.ndarray | None = None, *, n_frames: int,
                     n_cols: int = 1920, n_rows: int = 1080, n_sets_col: int = 11,
                     n_sets_row: int = 11, thresh_mode: str = "otsu",
                     shadow_val: float = 40.0, contrast_val: float = 10.0,
                     downsample: int = 1,
                     skip_remaining_before_row: bool = False) -> DecodeResult:
    """Decode a packed bit-plane stack (``io.images.pack_stack`` layout) on
    the host: bit-identical to ``decode_stack_np`` on the raw stack the
    planes were packed from, since thresholds and mask read only the
    verbatim white/black frames and the stored bits are the comparisons
    decode computes."""
    if texture is None:
        texture = np.repeat(white[..., None], 3, axis=-1).astype(np.uint8)
    shadow, contrast = _resolve_thresholds_np(np.stack([white, black]), thresh_mode,
                                              shadow_val, contrast_val)
    plan = decode_plan(n_frames, n_cols=n_cols, n_rows=n_rows,
                       n_sets_col=n_sets_col, n_sets_row=n_sets_row,
                       downsample=downsample,
                       skip_remaining_before_row=skip_remaining_before_row)
    need = 2 + 2 * (plan.n_bits_col + plan.n_bits_row)
    n_pairs = (n_frames - 2) // 2 if n_frames < need else None
    w16, b16 = white.astype(np.int16), black.astype(np.int16)
    mask = (w16 > shadow) & ((w16 - b16) > contrast)
    col_map = _decode_axis_packed_np(planes, 0, plan.n_bits_col, plan.n_use_col,
                                     n_pairs) * downsample
    row_map = _decode_axis_packed_np(planes, plan.n_bits_col, plan.n_bits_row,
                                     plan.n_use_row, n_pairs) * downsample
    return DecodeResult(col_map.astype(np.int32), row_map.astype(np.int32), mask,
                        texture)
