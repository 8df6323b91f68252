"""Index maps of the port's ransac_score, scan_fused and decode_packed CUDA
kernels, replayed on the CPU.

A CUDA kernel cannot run here, so what decides which thread touches which
element is rebuilt in numpy from the kernel's own constants (parsed from
``ops/csrc/*.cu``) and the grid arithmetic of its C entry, at ragged shapes:

- ``ransac_score_kernel``: blocks of 128 hypotheses (4 a lane: l, l + 32,
  l + 64, l + 96), correspondence spans sized from the SM count, tiles of
  the span, every kRsWarps-th row a warp, the warps' partials summed per
  hypothesis. Every (t, n) pair is scored exactly once, and the counts the
  replay accumulates (each pair's d2 in the kernel's float order) equal
  ``ransac_score_plain``'s exactly;
- ``scan_fused_bulk_kernel``: a persistent grid, block b taking tiles b,
  b + G, ... and every view of each. Every (view, pixel) is written exactly
  once (points through the warps' 16-byte vectors, valid and texture as
  4-byte words), each pixel's ray is read once, and each (view, frame,
  pixel) the decode needs is copied once (no row frame at row_mode 0). The
  kernel's word-wise decode (4 pixels' pattern > inverse compares on the
  bytes of one 32-bit word, the Gray bits gathered MSB first, a prefix XOR)
  is replayed bit for bit against the plain version's cascade;
- ``decode_packed_kernel``: the grid of (pixels / (256 * vec), views)
  blocks, 4 pixels a thread where H*W % 4 == 0 (one otherwise). Every
  (view, pixel) is written exactly once and each plane byte read once, at
  ragged shapes and 1, 3 and 8 plane bytes; the kernel's decode (a 64-bit
  word of a pixel's plane bytes, pair start + b at bit start + b, g = 0
  past the pairs in the stack, the XOR cascade, the rescale) is replayed bit
  for bit against the plain version and the Pallas kernel (interpret
  mode), on truncated stacks and at downsample 2.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.ops import graycode as jgc
from structured_light_for_3d_model_replication_tpu.ops import pallas_kernels as pk
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")


def _constants(name: str) -> dict[str, int]:
    """``constexpr int kX = <expr>;`` of a source, evaluated in order."""
    env: dict[str, int] = {}
    with open(os.path.join(CSRC, name)) as f:
        for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", f.read()):
            env[m.group(1)] = int(eval(m.group(2).replace("/", "//"), {}, dict(env)))
    return env


# ransac_score ------------------------------------------------------------------

def _ransac_inputs(rng, t, n, dead=False):
    hm = rng.normal(0, 1, (t, 16)).astype(np.float32)
    pm = rng.normal(0, 1, (n, 16)).astype(np.float32)
    sc = (rng.uniform(0, 4, n) + 8).astype(np.float32)
    sc[rng.random(n) < 0.1] = np.inf
    if dead:
        sc[:] = np.inf
    return hm, pm, sc


def _pair_verdicts(hm, pm, sc, md2):
    """[T, N] d2 <= md2, d2 = sc + 2 * dot summed c = 0..15, each step
    rounded to f32 as the kernel's __fmul_rn / __fadd_rn chain."""
    acc = hm[:, None, 0] * pm[None, :, 0]
    for c in range(1, 16):
        acc = acc + hm[:, None, c] * pm[None, :, c]
    return (sc[None, :] + np.float32(2) * acc) <= np.float32(md2)


def _ransac_replay(hm, pm, sc, md2, sms, k):
    """slscan_ransac_score's grid and ransac_score_kernel's loops: returns
    (visits [T, N], counts [T])."""
    T, N = hm.shape[0], pm.shape[0]
    hyps, warps, tile = k["kRsHyps"], k["kRsWarps"], k["kRsTile"]
    assert k["kRsThreads"] == hyps == 32 * k["kRsHpt"]
    gx = -(-T // hyps)
    want = max(1, -(-k["kRsBlocksPerSm"] * sms // gx))
    span = -(-(-(-N // want)) // tile) * tile
    gy = -(-N // span)
    verdict = _pair_verdicts(hm, pm, sc, md2)
    visits = np.zeros((T, N), np.int32)
    counts = np.zeros(T, np.int64)
    lanes = np.arange(32)
    for bx in range(gx):
        # thread (warp, lane) carries hypotheses lane + 32 j, j < kRsHpt
        t_of = (bx * hyps + lanes[:, None] + 32 * np.arange(k["kRsHpt"])[None, :]).ravel()
        live = t_of < T
        for by in range(gy):
            n0, n1 = by * span, min(N, by * span + span)
            part = np.zeros((warps, hyps), np.int64)  # indexed by 32 j + lane
            for s0 in range(n0, n1, tile):
                m = min(tile, n1 - s0)
                for w in range(warps):
                    rows = s0 + np.arange(w, m, warps)
                    if rows.size == 0:
                        continue
                    np.add.at(visits, (t_of[live][:, None], rows[None, :]), 1)
                    got = np.zeros(hyps, np.int64)
                    got[t_of[live] - bx * hyps] = verdict[np.ix_(t_of[live], rows)].sum(1)
                    part[w] += got
            total = part.sum(0)  # thread i sums hypothesis i over the warps
            t_blk = bx * hyps + np.arange(hyps)
            ok = t_blk < T
            counts[t_blk[ok]] += total[ok]
    return visits, counts, (gx, gy, span)


@pytest.mark.parametrize("t,n,sms,dead", [
    (37, 2100, 132, False),     # both ragged
    (4096, 1, 132, False),      # one correspondence
    (1, 2048, 132, False),      # one hypothesis
    (4096, 2048, 132, False),   # the merge path's shape: 16 warps an SM
    (512, 2048, 132, True),     # every correspondence dead: all counts 0
    (300, 777, 7, False),       # a small card: spans of several tiles
])
def test_ransac_score_block_split_replay_covers_every_pair_once(t, n, sms, dead):
    k = _constants("cloud.cu")
    rng = np.random.default_rng(t + n)
    hm, pm, sc = _ransac_inputs(rng, t, n, dead)
    md2 = 20.25
    visits, counts, (gx, gy, span) = _ransac_replay(hm, pm, sc, md2, sms, k)
    assert (visits == 1).all()
    plain = kernels.ransac_score(torch.from_numpy(hm), torch.from_numpy(pm),
                                 torch.from_numpy(sc), md2).numpy()
    np.testing.assert_array_equal(counts, plain)
    if dead:
        assert (counts == 0).all()
    else:
        assert counts.max() > 0
    assert span % k["kRsTile"] == 0 and gy <= 65535
    if (t, n, sms) == (4096, 2048, 132):  # ~kRsBlocksPerSm blocks an SM
        assert gx * gy >= (k["kRsBlocksPerSm"] - 1) * sms


# scan_fused --------------------------------------------------------------------

def _slot_frame(j, uc, start_row):
    return j if j < 2 + 2 * uc else start_row + (j - 2 - 2 * uc)


def _stages(nf, ccap, rcap, k, optin=232448):
    """slscan_scan_fused's stage count for the bulk kernel's shared memory."""
    tile, warps = k["kSfTile"], k["kSfWarps"]
    rest = 12 * tile + 4 * warps * k["kSfWarpOut"] + 16 * ccap + 16 * rcap + 128 + 16
    return min(k["kSfMaxStages"], max(0, optin - rest) // (nf * tile + 16))


def _bulk_replay(V, F, hw, row_mode, uc, ur, n_bits_col, sms, k):
    """scan_fused_bulk_kernel's producer copies and consumer writes; also
    returns the most tiles a block takes."""
    tile, ppt, warps = k["kSfTile"], k["kSfPpt"], k["kSfWarps"]
    assert k["kSfConsumers"] == tile // ppt == 32 * warps
    assert k["kSfWarpOut"] == 32 * ppt * 3
    ntiles = -(-hw // tile)
    grid = min(ntiles, sms)
    nf = 2 + 2 * uc + (2 * ur if row_mode == 1 else 0)
    ray_reads = np.zeros(hw, np.int32)
    frame_reads = np.zeros((V, F, hw), np.int32)
    pts_writes = np.zeros(V * hw * 3, np.int32)
    word_writes = np.zeros((V, hw), np.int32)
    most = 0
    for b in range(grid):
        mine = range(b, ntiles, grid)
        most = max(most, len(mine))
        for tl in mine:
            p0 = tl * tile
            cnt = min(tile, hw - p0)
            assert cnt % 16 == 0 and (12 * cnt) % 16 == 0  # bulk copy sizes
            ray_reads[p0:p0 + cnt] += 1
            for v in range(V):
                for j in range(nf):
                    frame_reads[v, _slot_frame(j, uc, 2 + 2 * n_bits_col), p0:p0 + cnt] += 1
                for t in range(tile // ppt):
                    if ppt * t < cnt:
                        word_writes[v, p0 + ppt * t:p0 + ppt * t + ppt] += 1
                for w in range(warps):
                    pw = min(max(cnt - 32 * ppt * w, 0), 32 * ppt)
                    base = 3 * (v * hw + p0 + 32 * ppt * w)
                    for lane in range(32):
                        for c in range(3):
                            m = lane + 32 * c
                            if 4 * m < 3 * pw:
                                pts_writes[base + 4 * m:base + 4 * m + 4] += 1
    return ray_reads, frame_reads, pts_writes, word_writes, most


@pytest.mark.parametrize("V,hw,row_mode,sms", [
    (3, 16 * 199, 1, 132),   # 4 tiles, the last of 112 pixels
    (2, 16 * 1000, 0, 3),    # row_mode 0; 3 blocks take 6, 5 and 5 tiles, the last ragged
    (1, 1024 * 3, 1, 2),     # one view; whole tiles, block 0 takes two
    (2, 1024 * 8, 1, 4),     # whole rounds only
])
def test_scan_fused_bulk_replay_writes_every_pixel_once(V, hw, row_mode, sms):
    k = _constants("decode.cu")
    n_bits_col, n_bits_row, uc, ur = 11, 11, 10, 11
    F = 2 + 2 * (n_bits_col + n_bits_row)
    rays, frames, pts, words, most = _bulk_replay(V, F, hw, row_mode, uc, ur, n_bits_col,
                                                  sms, k)
    ntiles = -(-hw // k["kSfTile"])
    assert most == -(-ntiles // min(ntiles, sms))
    assert (rays == 1).all()          # each ray once, for all views
    assert (pts == 1).all() and (words == 1).all()
    need = set(range(2 + 2 * uc))
    if row_mode == 1:
        need |= set(range(2 + 2 * n_bits_col, 2 + 2 * n_bits_col + 2 * ur))
    for f in range(F):
        assert (frames[:, f] == (1 if f in need else 0)).all(), f
    # the flagship stack (46 frames, a 1920 x 1080 projector) gets three
    # stages of shared memory at row_mode 1 and more at row_mode 0
    assert _stages(46, 1920, 1080, k) == 3
    assert _stages(24, 1920, 0, k) > 3


_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint32)


def _brev(x):
    return ((_REV8[x & 0xFF] << 24) | (_REV8[(x >> 8) & 0xFF] << 16)
            | (_REV8[(x >> 16) & 0xFF] << 8) | _REV8[x >> 24]).astype(np.uint32)


def _bytes_gt(a, b):
    """decode.cu bytes_gt: per byte a > b at bit 7."""
    d = (b | np.uint32(0x80808080)) - (a & np.uint32(0x7F7F7F7F))
    return (a & ~b) | (~(a ^ b) & ~d)


def _decode_words(words, j0, n, n_bits, max_bits):
    """decode.cu decode_words on [slots, n_words] little-endian words ->
    codes [n_words * 4] (pixel 4 i + k from byte k of word i)."""
    hi = np.zeros(words.shape[1], np.uint32)
    lo = np.zeros_like(hi)
    keep, top = np.uint32(0x7F7F7F7F), np.uint32(0x80808080)
    for q in range(min(n, max_bits)):
        g = _bytes_gt(words[j0 + 2 * q], words[j0 + 2 * q + 1])
        if q < 8:
            hi = ((hi >> 1) & keep) | (g & top)
        else:
            lo = ((lo >> 1) & keep) | (g & top)
    n2 = max(n - 8, 0)
    hr, lr = _brev(hi), _brev(lo)
    out = np.zeros((words.shape[1], 4), np.int64)
    for kk in range(4):
        b = (((hr >> (8 * (3 - kk))) & 0xFF) << n2) | ((lr >> (8 * (3 - kk))) & 0xFF)
        for s in (1, 2, 4, 8):
            b = b ^ (b >> s)
        out[:, kk] = b.astype(np.int64) << (n_bits - n)
    return out.ravel()


def test_bytes_gt_matches_every_byte_pair():
    a, b = (x.ravel().astype(np.uint8) for x in np.meshgrid(np.arange(256), np.arange(256)))
    wa, wb = a.view("<u4"), b.view("<u4")
    g = _bytes_gt(wa, wb)
    bit7 = ((g[:, None] >> (8 * np.arange(4) + 7)) & 1).ravel().astype(bool)
    np.testing.assert_array_equal(bit7, a > b)


@pytest.mark.parametrize("n_bits,n_use", [(11, 11), (11, 10), (8, 8), (9, 9), (16, 16),
                                          (4, 1)])
def test_word_decode_equals_plain_cascade(n_bits, n_use):
    k = _constants("decode.cu")
    rng = np.random.default_rng(n_bits * 100 + n_use)
    F = 2 + 4 * n_bits
    hw = 64 * 48
    frames = rng.integers(0, 256, (1, F, 48, 64), dtype=np.uint8)
    frames[0, 2:2 + 2 * n_use:2, :, :7] = frames[0, 3:3 + 2 * n_use:2, :, :7]  # ties: not >
    col, row, _ = kernels.decode_maps_plain(
        torch.from_numpy(frames), torch.zeros((1, 2)), n_bits_col=n_bits, n_bits_row=n_bits,
        n_use_col=n_use, n_use_row=n_use)
    words = np.ascontiguousarray(frames[0].reshape(F, hw)).view("<u4")
    got_c = _decode_words(words, 2, n_use, n_bits, k["kSfMaxBits"])
    got_r = _decode_words(words, 2 + 2 * n_bits, n_use, n_bits, k["kSfMaxBits"])
    np.testing.assert_array_equal(got_c, col.numpy().ravel())
    np.testing.assert_array_equal(got_r, row.numpy().ravel())
    assert math.log2(col.max().item() + 1) <= n_bits


# decode_packed ------------------------------------------------------------------

def _packed_map_replay(V, pb, hw, vec, threads):
    """slscan_decode_packed_maps' grid (grid_for: hw / (kThreads * vec)
    blocks a view, the view on grid.y) and decode_packed_kernel's map: thread
    t of block (bx, v) owns pixels [p, p + vec), p = (bx * kThreads + t) *
    vec, where p < hw; it reads plane byte j of each at (v * pb + j) * hw + p
    and writes col, row and mask at v * hw + p. Returns (writes [V * hw],
    plane byte reads [V * pb * hw])."""
    gx = -(-hw // (threads * vec))
    p = np.arange(gx * threads) * vec
    p = p[p < hw]
    writes = np.zeros(V * hw, np.int32)
    reads = np.zeros(V * pb * hw, np.int32)
    for v in range(V):
        for kk in range(vec):
            np.add.at(writes, v * hw + p + kk, 1)
            for j in range(pb):
                np.add.at(reads, (v * pb + j) * hw + p + kk, 1)
    return writes, reads


@pytest.mark.parametrize("V,pb,h,w", [
    (1, 1, 24, 40),    # H*W % 16 == 0: 4 pixels a thread, one partial block
    (3, 3, 25, 41),    # H*W odd: one pixel a thread
    (8, 8, 12, 36),    # eight plane bytes, H*W % 16 == 0
    (3, 1, 13, 20),    # H*W % 16 == 4: 4 pixels a thread, a ragged block
    (8, 3, 30, 30),    # eight views, H*W % 16 == 4
    (1, 8, 7, 9),      # H*W = 63 < one block
])
def test_decode_packed_map_writes_every_pixel_once(V, pb, h, w):
    k = _constants("decode.cu")
    hw = h * w
    planes = torch.zeros((V, pb, h, w), dtype=torch.uint8)
    vec = kernels._vec(hw, planes)
    assert vec == (4 if hw % 4 == 0 else 1)
    writes, reads = _packed_map_replay(V, pb, hw, vec, k["kThreads"])
    assert (writes == 1).all()
    assert (reads == 1).all()


def _decode_axis_bits(planes, start, n_bits, n_use, avail, downsample):
    """decode.cu decode_axis_bits on plane bytes [pb, n]: a pixel's word
    holds plane byte j at bits 8j..8j+7, so bit b of the axis is bit
    start + b of the word (g = 0 for b >= avail); the XOR cascade MSB first,
    then the rescale shift and the downsample, in int32."""
    word = np.zeros(planes.shape[1], np.uint64)
    for j in range(planes.shape[0]):
        word |= planes[j].astype(np.uint64) << np.uint64(8 * j)
    binary = np.zeros(planes.shape[1], np.int64)
    prev = np.zeros_like(binary)
    for b in range(n_use):
        if b < avail:
            prev ^= ((word >> np.uint64(start + b)) & np.uint64(1)).astype(np.int64)
        binary = (binary << 1) | prev
    return ((binary << (n_bits - n_use)) * downsample).astype(np.int32)


def _zero_pairs_from(planes, n_pairs):
    """Planes [pb, ...] with every pair p >= n_pairs cleared."""
    out = planes.copy()
    for p in range(n_pairs, 8 * planes.shape[0]):
        out[p >> 3] &= np.uint8(0xFF ^ (1 << (p & 7)))
    return out


def _pattern_planes(rng):
    """A 64 x 32 projector's stack (6 + 5 bits, 11 pairs) with seeded noise,
    packed: (planes u8 [2, 32, 64], white, black)."""
    frames = jgc.generate_pattern_stack(64, 32).astype(np.int16)
    frames = np.clip(frames + rng.integers(-90, 91, frames.shape), 0, 255).astype(np.uint8)
    ps = jimio.pack_stack(frames)
    assert ps.n_pairs == 11 and ps.planes.shape[0] == 2
    return ps.planes, ps.white, ps.black


@pytest.mark.parametrize("case", ["pattern", "fewer bits used", "truncated to 8 pairs",
                                  "truncated to 5 pairs", "downsample 2", "Pb=3 random",
                                  "Pb=8 random"])
def test_decode_packed_bits_replay_equals_plain_and_pallas(case):
    rng = np.random.default_rng(len(case))
    if case.endswith("random"):
        pb = int(case[3])
        n_pairs, nb = (22, 11) if pb == 3 else (62, 31)
        planes = rng.integers(0, 256, (pb, 20, 48), dtype=np.uint8)
        white = rng.integers(0, 256, (20, 48), dtype=np.uint8)
        black = rng.integers(0, 256, (20, 48), dtype=np.uint8)
        kw = dict(n_bits_col=nb, n_bits_row=nb, n_use_col=nb, n_use_row=nb)
    else:
        planes, white, black = _pattern_planes(rng)
        n_pairs = 11
        kw = dict(n_bits_col=6, n_bits_row=5, n_use_col=6, n_use_row=5)
    ds = 2 if case == "downsample 2" else 1
    if case == "fewer bits used":
        kw.update(n_use_col=4, n_use_row=3)
    full = planes
    if case.startswith("truncated"):
        n_pairs = int(case.split()[2])
        planes = planes[:-(-n_pairs // 8)]
        full = _zero_pairs_from(full, n_pairs)
    shadow, contrast = 40.0, 10.0
    got = kernels.decode_packed_maps(
        torch.from_numpy(planes)[None], torch.from_numpy(white)[None],
        torch.from_numpy(black)[None], torch.tensor([[shadow, contrast]]), n_pairs=n_pairs,
        downsample=ds, **kw)
    col, row, mask = (a[0].numpy() for a in got)
    flat = planes.reshape(planes.shape[0], -1)
    nbc, nuc, nur = kw["n_bits_col"], kw["n_use_col"], kw["n_use_row"]
    rep_c = _decode_axis_bits(flat, 0, nbc, nuc, kernels._avail(nuc, n_pairs), ds)
    rep_r = _decode_axis_bits(flat, nbc, kw["n_bits_row"], nur,
                              kernels._avail(nur, n_pairs - nbc), ds)
    np.testing.assert_array_equal(col.ravel(), rep_c)
    np.testing.assert_array_equal(row.ravel(), rep_r)
    jc, jr, jm = (np.asarray(a) for a in pk.decode_packed_maps_fused(
        full, white, black, shadow, contrast, interpret=True, **kw))
    np.testing.assert_array_equal(col, jc * ds)
    np.testing.assert_array_equal(row, jr * ds)
    np.testing.assert_array_equal(mask, jm)
    if case == "truncated to 5 pairs":  # the kept byte's pairs 5..7 are set, and ignored
        assert (planes[0] != full[0]).any()
