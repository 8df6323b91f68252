"""Gray decode of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (seeded) go through both packages. On the CPU the
port's decode runs the plain versions of its kernels; the JAX side runs
``decode_stack_np`` / ``decode_packed_np`` and the Pallas kernels in
interpret mode (as the JAX package's own tests do). Decode maps and masks
are integers and booleans: every comparison here is exact. Nothing here
multiplies matrices, so TF32 plays no part.
"""
import jax
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.ops import graycode as jgc
from structured_light_for_3d_model_replication_tpu.ops import pallas_kernels as pk
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.ops import graycode as gc
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

PROJ = (256, 64)


def _noisy(frames, seed, amp=20):
    rng = np.random.default_rng(seed)
    noise = rng.integers(-amp, amp + 1, frames.shape)
    return np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _assert_same(a, b):
    for x, y in ((a.col_map, b.col_map), (a.row_map, b.row_map),
                 (a.mask, b.mask)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("w,h,ds", [(256, 64, 1), (200, 60, 1), (256, 128, 2)])
def test_pattern_stack_byte_equal(w, h, ds):
    np.testing.assert_array_equal(gc.generate_pattern_stack(w, h, 200, ds),
                                  jgc.generate_pattern_stack(w, h, 200, ds))
    assert gc.frames_per_view(w, h, ds) == jgc.frames_per_view(w, h, ds)
    np.testing.assert_array_equal(gc.gray_bits(w), jgc.gray_bits(w))


# (name, pattern downsample, n_sets_col, n_sets_row, frames cut off the end,
#  thresh_mode)
CASES = [
    ("full", 1, 11, 11, 0, "manual"),
    ("partial_bits", 1, 5, 4, 0, "manual"),
    ("downsample2", 2, 11, 11, 0, "manual"),
    ("truncated", 1, 11, 11, 5, "manual"),
    ("otsu", 1, 11, 11, 0, "otsu"),
]


@pytest.mark.parametrize("name,ds,nsc,nsr,cut,mode", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_matches_numpy_reference(name, ds, nsc, nsr, cut, mode):
    frames = _noisy(gc.generate_pattern_stack(*PROJ, downsample=ds), seed=3)
    if cut:
        frames = frames[:-cut]
    kw = dict(n_cols=PROJ[0], n_rows=PROJ[1], n_sets_col=nsc, n_sets_row=nsr,
              thresh_mode=mode, shadow_val=40.0, contrast_val=10.0,
              downsample=ds, skip_remaining_before_row=bool(cut))
    ref = jgc.decode_stack_np(frames, **kw)
    _assert_same(gc.decode_stack(frames, device="cpu", **kw), ref)
    # the packed codec decodes to the same maps (raw decode == packed decode)
    ps = imio.pack_stack(frames)
    ref_p = jgc.decode_packed_np(ps.planes, ps.white, ps.black,
                                 n_frames=ps.n_frames, **kw)
    _assert_same(ref_p, ref)
    _assert_same(gc.decode_packed(ps.planes, ps.white, ps.black,
                                  n_frames=ps.n_frames, device="cpu", **kw), ref)


@pytest.mark.parametrize("nsc,nsr", [(11, 11), (5, 4)])
def test_decode_kernels_match_pallas_interpret(nsc, nsr):
    frames = _noisy(gc.generate_pattern_stack(*PROJ), seed=5)
    nbc, nbr = 8, 6
    kw = dict(n_bits_col=nbc, n_bits_row=nbr, n_use_col=min(nsc, nbc),
              n_use_row=min(nsr, nbr))
    thr = torch.tensor([[40.0, 10.0]])
    col, row, mask = kernels.decode_maps(torch.from_numpy(frames)[None], thr, **kw)
    rc, rr, rm = pk.decode_maps_fused(frames, 40.0, 10.0, interpret=True, **kw)
    np.testing.assert_array_equal(col[0].numpy(), np.asarray(rc))
    np.testing.assert_array_equal(row[0].numpy(), np.asarray(rr))
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(rm))

    ps = jimio.pack_stack(frames)
    pc, pr, pm = kernels.decode_packed_maps(
        torch.from_numpy(ps.planes)[None], torch.from_numpy(ps.white)[None],
        torch.from_numpy(ps.black)[None], thr, n_pairs=ps.n_pairs, **kw)
    qc, qr, qm = pk.decode_packed_maps_fused(ps.planes, ps.white, ps.black,
                                             40.0, 10.0, interpret=True, **kw)
    np.testing.assert_array_equal(pc[0].numpy(), np.asarray(qc))
    np.testing.assert_array_equal(pr[0].numpy(), np.asarray(qr))
    np.testing.assert_array_equal(pm[0].numpy(), np.asarray(qm))


def test_views_with_per_view_thresholds_match_pallas_views_kernel():
    """V=2 with different thresholds: the port's view axis against the JAX
    view-batched Pallas kernel (jax.vmap dispatches _decode_call_views) and
    against per-view decode_stack_np."""
    ramp = (0.4 + 0.6 * np.linspace(0, 1, PROJ[0]))[None, None, :]
    base = np.clip(gc.generate_pattern_stack(*PROJ) * ramp, 0, 255).astype(np.uint8)
    frames_v = np.stack([_noisy(base, 11, amp=40), _noisy(base, 12, amp=40)])
    thr = np.array([[40.0, 10.0], [120.0, 30.0]], np.float32)
    kw = dict(n_bits_col=8, n_bits_row=6, n_use_col=8, n_use_row=6)
    col, row, mask = kernels.decode_maps(torch.from_numpy(frames_v),
                                         torch.from_numpy(thr), **kw)
    jc, jr, jm = jax.vmap(lambda f, s, c: pk.decode_maps_fused(
        f, s, c, interpret=True, **kw))(frames_v, thr[:, 0], thr[:, 1])
    np.testing.assert_array_equal(col.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert not np.array_equal(mask[0].numpy(), mask[1].numpy())
    for v in range(2):
        ref = jgc.decode_stack_np(frames_v[v], n_cols=PROJ[0], n_rows=PROJ[1],
                                  thresh_mode="manual", shadow_val=thr[v, 0],
                                  contrast_val=thr[v, 1])
        np.testing.assert_array_equal(mask[v].numpy(), ref.mask)
        np.testing.assert_array_equal(col[v].numpy(), ref.col_map)


def test_black_brighter_than_white_is_masked_out():
    """uint8 ``white - black`` would wrap (50 - 250 = 56 > contrast); the
    port widens first, as the JAX package does."""
    frames = gc.generate_pattern_stack(*PROJ)
    frames[0, 5, :] = 50
    frames[1, 5, :] = 250
    kw = dict(n_cols=PROJ[0], n_rows=PROJ[1], thresh_mode="manual",
              shadow_val=40.0, contrast_val=10.0)
    port = gc.decode_stack(frames, device="cpu", **kw)
    ref = jgc.decode_stack_np(frames, **kw)
    assert not port.mask[5].any()
    _assert_same(port, ref)


def test_otsu_thresholds_match_reference():
    base = gc.generate_pattern_stack(*PROJ)
    ramp = (0.4 + 0.6 * np.linspace(0, 1, PROJ[0]))[None, None, :]
    frames_v = np.stack([_noisy(np.clip(base * ramp, 0, 255).astype(np.uint8),
                                20 + v, amp=10 + 10 * v) for v in range(3)])
    ss, cs = gc.resolve_thresholds_views(torch.from_numpy(frames_v), "otsu",
                                         40.0, 10.0)
    jss, jcs = jgc.resolve_thresholds_views(frames_v, "otsu", 40.0, 10.0)
    np.testing.assert_array_equal(ss, jss)
    np.testing.assert_array_equal(cs, jcs)
    assert gc.otsu_threshold(torch.from_numpy(frames_v[1, 0])) == \
        jgc.otsu_threshold_np(frames_v[1, 0])
    assert gc.resolve_thresholds(torch.from_numpy(frames_v[2]), "otsu", 40.0,
                                 10.0) == jgc.resolve_thresholds(
        frames_v[2], "otsu", 40.0, 10.0)


def test_short_stack_raises_without_skip_flag():
    frames = gc.generate_pattern_stack(*PROJ)[:-3]
    with pytest.raises(ValueError, match="Not enough frames"):
        gc.decode_stack(frames, n_cols=PROJ[0], n_rows=PROJ[1],
                        thresh_mode="manual", device="cpu")
