"""The merge path's kernels (plain versions, on the CPU) against the JAX package.

Each plain version in ``ops/kernels.py`` is what a CUDA kernel of
``ops/csrc/cloud.cu`` is held against on the card; here it is held against
the Pallas kernel it replaces, run in interpret mode as the JAX package's own
tests run it, and against the package's numpy twins. Inputs are made with
numpy from a seed. Tolerances:

- nn1: indices equal wherever the best two exact distances differ by more
  than 1e-3 mm^2 (the Pallas kernel selects on the |q|^2+|b|^2-2q.b
  expansion, the port on exact differences, so nearer ties may split
  either way); distances are exact differences, equal to within f32
  rounding of the same formula (rtol 1e-6);
- ransac_score: counts within +-1, the bound of pallas_kernels.py:325 (f32
  products summed in another order flip borderline slots);
- knn_mean: counts exact, means rtol 1e-4 (knn_mean_np's bound; the sums
  differ only in order);
- slab_mean_knn: counts and window ends exact, certified means within rtol
  1e-5 of the Pallas kernel and of the cKDTree twin
  (tests/test_pointcloud_ops.py:356's bound);
- the selection kernels' statistic (the sorted k smallest bit patterns a
  one-sweep k-selection keeps, rebuilt here in numpy, for the slab windows
  and for the whole cloud with the sweep's start rotated): its k-list equal
  to the sorted k smallest, counts exact, means within rtol 1e-5 of the
  plain version's _knn_mean_rows and of the Pallas kernel, on every row;
- nn1's lane reduction (per-lane strict-'<' scans, then a (d2, j)
  lexicographic butterfly, rebuilt in numpy): indices and distances equal
  to one sequential scan and to the plain version, bit for bit, and on a
  lattice to the Pallas kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import pallas_kernels as pk
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.ops import registration as jreg
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lumpy(rng, n, scale=50.0, center=(0.0, 0.0, 400.0)):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = scale * (1 + 0.2 * np.sin(3 * d[:, 0]))
    return (d * r[:, None] + np.asarray(center)).astype(np.float32)


@pytest.mark.parametrize("nq,nb", [(300, 500), (257, 130)])
def test_nn1_matches_pallas_and_brute(nq, nb):
    rng = np.random.default_rng(nq + nb)
    q = _lumpy(rng, nq) + rng.normal(0, 0.5, (nq, 3)).astype(np.float32)
    base = _lumpy(rng, nb)
    base[7] = base[3]                        # an exact tie: lowest index wins
    q[0] = base[3] + 0.25
    valid = rng.random(nb) > 0.1
    valid[[3, 7]] = True
    parked = np.where(valid[:, None], base, np.float32(knnlib.FAR)).astype(np.float32)
    idx, d2 = (a.numpy()[0] for a in kernels.nn1(_t(q)[None], _t(parked)[None]))
    jidx, jd2 = (np.asarray(a) for a in pk.nn1(q, base, valid))
    bidx, bd2 = (np.asarray(a) for a in jreg._nn1_brute_jnp(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(valid)))
    exact = ((q[:, None, :] - parked[None]) ** 2).sum(-1)
    two = np.sort(exact, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-3
    assert clear.sum() > 0.9 * nq
    np.testing.assert_array_equal(idx[clear], jidx[clear])
    np.testing.assert_array_equal(idx[clear], bidx[clear])
    assert valid[idx].all()
    np.testing.assert_allclose(d2, exact[np.arange(nq), idx], rtol=1e-6)
    np.testing.assert_allclose(d2, jd2, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(d2[np.isfinite(bd2)], bd2[np.isfinite(bd2)],
                               rtol=1e-5, atol=1e-3)
    # base rows 3 and 7 coincide: the tie goes to the lower index
    assert idx[0] == 3 and not (idx == 7).any()


def test_nn1_pair_axis_equals_one_pair_at_a_time():
    rng = np.random.default_rng(4)
    q = np.stack([_lumpy(rng, 200) for _ in range(3)])
    b = np.stack([_lumpy(rng, 150) for _ in range(3)])
    idx, d2 = kernels.nn1(_t(q), _t(b))
    for p in range(3):
        i1, d1 = kernels.nn1(_t(q[p:p + 1]), _t(b[p:p + 1]))
        assert torch.equal(idx[p], i1[0]) and torch.equal(d2[p], d1[0])


def _ransac_inputs(rng, t, n):
    src = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 2.0, (n, 3))).astype(np.float32)
    src_c, dst_cc = src - src.mean(0), dst - dst.mean(0)
    cs9 = (dst_cc[:, :, None] * src_c[:, None, :]).reshape(n, 9)
    ang = rng.normal(0, 0.05, (t, 3))
    R = np.stack([np.linalg.qr(np.eye(3) + _skew(a))[0] for a in ang]).astype(np.float32)
    R *= np.sign(np.linalg.det(R))[:, None, None]
    tt = rng.normal(0, 1.0, (t, 3)).astype(np.float32)
    Rt = np.einsum("tij,ti->tj", R, tt).astype(np.float32)
    sc = ((src_c ** 2).sum(-1) + (dst_cc ** 2).sum(-1)).astype(np.float32)
    sc[rng.random(n) < 0.1] = np.inf
    return (R.reshape(t, 9), tt, (tt * tt).sum(-1).astype(np.float32), Rt,
            src_c, cs9.astype(np.float32), dst_cc, sc)


def _skew(a):
    return np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])


@pytest.mark.parametrize("t,n", [(64, 700), (37, 2100)])
def test_ransac_score_matches_pallas_and_twin(t, n):
    rng = np.random.default_rng(t * n)
    args = _ransac_inputs(rng, t, n)
    hm, pm = reg._ransac_rows(*(_t(a) for a in args[:7]))
    got = kernels.ransac_score(hm, pm, _t(args[7]), 20.25).numpy()
    ref = np.asarray(pk.ransac_score(*(jnp.asarray(a) for a in args), 20.25,
                                     interpret=True))
    twin = pk.ransac_score_np(*args, 20.25)
    assert ref.max() > 0 and got.min() >= 0
    assert np.abs(got - ref).max() <= 1
    assert np.abs(got - twin).max() <= 1


@pytest.mark.parametrize("n,n_valid", [(700, 650), (20, 6)])
def test_knn_mean_matches_pallas_and_twin(n, n_valid):
    """Duplicates (ties at zero), a far cluster, invalid rows; with 6 valid
    rows every row has fewer than k neighbours and comes back +inf."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 20, (n, 3)).astype(np.float32)
    pts[10:14] = pts[5]
    pts[n // 2:n // 2 + 5] = rng.uniform(500, 501, (5, 3))
    valid = np.arange(n) < n_valid
    k = 8
    md = pc._voxelized_knn_mean_dist(_t(pts), _t(valid), 1.0, k, selector="dense").numpy()
    parked = np.where(valid[:, None], pts, np.float32(knnlib.FAR)).astype(np.float32)
    _, cnt = kernels.knn_mean(_t(parked), k)
    cnt = np.where(valid, cnt.numpy(), 0)
    jmd, jcnt = (np.asarray(a) for a in pk.knn_mean(pts, valid, k, interpret=True))
    tmd, tcnt = pk.knn_mean_np(pts, valid, k)
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_array_equal(cnt, tcnt)
    fin = np.isfinite(jmd)
    np.testing.assert_array_equal(np.isfinite(md), fin)
    assert fin.sum() == (n_valid if n_valid > k else 0)
    np.testing.assert_allclose(md[fin], jmd[fin], rtol=1e-4)
    np.testing.assert_allclose(md[fin], tmd[fin], rtol=1e-4)


def _sorted_padded(pts, L):
    order = np.argsort(pts[:, 0], kind="stable")
    out = np.full((L, 3), 3e9, np.float32)
    out[:len(pts)] = pts[order]
    return out


def test_slab_mean_knn_matches_pallas():
    rng = np.random.default_rng(12)
    pts = rng.uniform(0, 30, (6000, 3)).astype(np.float32)
    s = _sorted_padded(pts, 6144)
    md, cnt, end = (a.numpy() for a in kernels.slab_mean_knn(_t(s), 6.0, 20, tile=128, wblk=2048))
    jmd, jcnt, jend = (np.asarray(a) for a in pk.slab_mean_knn(
        jnp.asarray(s), 6.0, 20, tile=128, wblk=2048, interpret=True))
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_array_equal(end, jend)
    ok = cnt >= 20
    assert ok.sum() > 5000
    np.testing.assert_allclose(md[ok], jmd[ok], rtol=1e-5)


def test_slab_engine_matches_pallas_engine_and_kdtree():
    rng = np.random.default_rng(12)
    pts = rng.uniform(0, 30, (6000, 3)).astype(np.float32)
    v = np.ones(len(pts), bool)
    b = pc._voxelized_knn_mean_dist(_t(pts), _t(v), 1.5, 20, tile=128, window=2048,
                                    selector="bisect").numpy()
    jb = np.asarray(jpc._voxelized_knn_mean_dist(
        jnp.asarray(pts), jnp.asarray(v), jnp.float32(1.5), 20, tile=128,
        window=2048, selector="bisect"))
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(jb))
    rows = np.flatnonzero(np.isfinite(b))
    assert len(rows) > 1000
    np.testing.assert_allclose(b[rows], jb[rows], rtol=1e-5)
    ref = jknn.kdtree_distances_rows(pts, v, rows, 20).mean(axis=1)
    np.testing.assert_allclose(b[rows], ref, rtol=1e-5)
    ours = knnlib.kdtree_distances_rows(pts, v, rows, 20).mean(axis=1)
    np.testing.assert_array_equal(ours, ref)


_INT_MAX = np.int32(0x7FFFFFFF)


def _d2_bits(q, c):
    """f32 ((dx*dx + dy*dy) + dz*dz), each step rounded, as int32 bits."""
    d = (q[:, None, :] - c[None, :, :]).astype(np.float32)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return d2.astype(np.float32).view(np.int32)


_LANES = np.arange(32)


def _segments(k):
    """List segments the selection kernels keep for k: E = 1, 2, 4 (cloud.cu
    slscan_slab_mean_knn, slscan_knn_mean)."""
    return 1 if k <= 32 else 2 if k <= 64 else 4


def _bitonic_sort(v):
    """cloud.cu warp_sort_asc: one value a lane, the bitonic network."""
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride:
            o = v[_LANES ^ stride]
            keep_min = ((_LANES & size) == 0) == ((_LANES & stride) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            stride >>= 1
        size <<= 1
    return v


def _half_clean(x):
    """The half-cleaner cascade that sorts a bitonic sequence across lanes."""
    for stride in (16, 8, 4, 2, 1):
        o = x[_LANES ^ stride]
        x = np.where((_LANES & stride) == 0, np.minimum(x, o), np.maximum(x, o))
    return x


def _list_flush(segs, vals, k, r2b):
    """cloud.cu sel_flush on a list of E sorted 32-entry segments: up to 32
    queued values (the other lanes INT_MAX) sorted, then cascaded through
    the segments in order — min and max of a segment and the values
    reversed, each half-cleaned; the segment keeps the low 32, the high 32
    go on, the last segment's (and every segment's from entry k on) are
    dropped. Returns tau = min(r2b + 1, entry k - 1)."""
    v = np.full(32, _INT_MAX, np.int32)
    v[:len(vals)] = vals
    v = _bitonic_sort(v)
    for s in range(len(segs)):
        if s > 0 and 32 * s >= k:
            break
        r = v[::-1]
        segs[s], v = _half_clean(np.minimum(segs[s], r)), _half_clean(np.maximum(segs[s], r))
    return min(r2b + 1, int(segs[(k - 1) // 32][(k - 1) % 32]))


def _warp_select(bits, k, r2b):
    """One query's sweep as the slab selection kernel makes it: 32 lanes a
    step; bits under tau = min(k-th kept, r2b + 1) queue up; at 32 queued
    the queue merges into the list of E segments and tau tightens. bits:
    the window's bit patterns with the query's own slot already dropped.
    Returns the list, 32 E entries ascending."""
    segs = [np.full(32, _INT_MAX, np.int32) for _ in range(_segments(k))]
    tau = r2b + 1
    queue = []
    for s in range(0, len(bits), 32):
        queue += [b for b in bits[s:s + 32] if b < tau]
        if len(queue) >= 32:
            tau = _list_flush(segs, queue[:32], k, r2b)
            queue = queue[32:]
    if queue:
        _list_flush(segs, queue, k, r2b)
    return np.concatenate(segs)


def _selection_statistic(lst, k, r2b):
    """(mean) from a sorted list of at least k entries, cloud.cu sel_mean:
    t = min(k-th, r2b + 1); sqrt of the entries < t summed by a butterfly
    over each 32-entry segment, the segments in order; plus (k - #less) *
    sqrt(t), over k."""
    t = min(int(lst[k - 1]), r2b + 1)
    total, c_lt = np.float32(0.0), 0
    for s in range(_segments(k)):
        seg = lst[32 * s:32 * s + 32]
        lt = (32 * s + _LANES < k) & (seg < t)
        x = np.where(lt, np.sqrt(seg.view(np.float32)), np.float32(0)).astype(np.float32)
        for o in (16, 8, 4, 2, 1):
            x = (x + x[_LANES ^ o]).astype(np.float32)
        total = x[0] if s == 0 else np.float32(total + x[0])
        c_lt += int(lt.sum())
    tie = np.float32(k - c_lt) * np.sqrt(np.int32(t).view(np.float32))
    return np.float32((total + tie) / np.float32(k))


def _selection_cloud(case, rng):
    base = rng.uniform(0, 30, (1100, 3)).astype(np.float32)
    if case == "ties":        # every row twice: exact ties at the k-th distance
        pts = np.concatenate([base[:1000], base[:1000]])
    elif case == "sparse":    # most rows have fewer than k within r
        pts = rng.uniform(0, 300, (1800, 3)).astype(np.float32)
    else:
        pts = base
    return _sorted_padded(pts, 2048)


@pytest.mark.parametrize("case,k", [("ties", 20), ("sparse", 20), ("self", 20), ("ties", 1),
                                    ("self", 32)] + [(c, k) for k in (33, 40, 64, 100, 128)
                                                     for c in ("ties", "sparse", "self")])
def test_selection_statistic_matches_plain_rows_and_pallas(case, k):
    """The identity the one-sweep slab kernel relies on: the statistic built
    from the sorted k smallest bit patterns (self excluded by index, only
    bits <= r2b kept) equals the bisection's, whatever the tie-breaking."""
    rng = np.random.default_rng(len(case) * 100 + k)
    s = _selection_cloud(case, rng)
    # above one segment, a radius that holds over k neighbours (the lists
    # fill) and one window of the whole cloud, which then holds it
    L, tile = s.shape[0], 64
    wblk, r = (512, 6.0) if k <= 32 else (1024, 12.0)
    r2b = kernels._sq_bits(r)
    x = s[:, 0]
    starts = np.minimum(np.searchsorted(x, x[::tile] - np.float32(r)) // wblk,
                        L // wblk - 2) * wblk
    np.testing.assert_array_equal(starts, kernels._slab_starts(_t(s), r, tile, wblk).numpy())
    means = np.zeros(L, np.float32)
    cnts = np.zeros(L, np.int32)
    self_in = 0
    for t0 in range(0, L, tile):
        c0 = int(starts[t0 // tile])
        cand = np.arange(c0, c0 + 2 * wblk)
        qg = np.arange(t0, t0 + tile)
        bits = _d2_bits(s[qg], s[cand])
        own = qg[:, None] == cand[None, :]
        self_in += int(own.any(1).sum())
        m, c = kernels._knn_mean_rows(_t(bits.view(np.float32)), _t(own), k, r2b)
        for i in range(tile):
            b = bits[i][~own[i]]
            kept = np.sort(np.where(b <= r2b, b, _INT_MAX))[:32 * _segments(k)]
            if i % 16 == 0:   # the kernel's stream of queue merges keeps the same list
                np.testing.assert_array_equal(_warp_select(b, k, r2b)[:k], kept[:k])
            means[t0 + i] = _selection_statistic(kept, k, r2b)
            cnts[t0 + i] = int((b <= r2b).sum())
        np.testing.assert_array_equal(cnts[qg], c.numpy())
        np.testing.assert_allclose(means[qg], m.numpy(), rtol=1e-5)
    jmd, jcnt, jend = (np.asarray(a) for a in pk.slab_mean_knn(
        jnp.asarray(s), r, k, tile=tile, wblk=wblk, interpret=True))
    np.testing.assert_array_equal(cnts, jcnt)
    np.testing.assert_array_equal(np.repeat(starts + 2 * wblk, tile), jend)
    np.testing.assert_allclose(means, jmd, rtol=1e-5)
    assert self_in == L                       # every query's own slot is in its window
    few = (cnts < k).mean()
    if case == "sparse":
        assert few > 0.5
    elif case == "ties":
        assert (cnts[:1000] >= 1).all()       # each real row's twin, at d2 = 0
    else:
        assert few < 0.5


_CHUNK = 1024       # knn_select_kernel's ring slot (cloud.cu kSelChunk)
_BLOCK_Q = 64       # queries a block (kSelTile)
_INF_BITS = np.int32(0x7F800000)


def _dense_stream(bits, qg, k, r2b):
    """One query's sweep as knn_select_kernel makes it: the whole cloud in
    chunks of _CHUNK rows, starting at the chunk that holds the first query
    of the query's block and wrapping around; each chunk's tail padded to a
    whole warp step with +inf; 32 lanes a step; a candidate other than the
    query itself queues where bits < tau = min(k-th kept, r2b + 1); at 32
    queued the queue merges into the list of E sorted 32-entry segments and
    tau tightens. bits: the query's bit patterns against every row, own slot
    included. Returns (list, count of bits <= r2b without the own slot)."""
    L = len(bits)
    nch = -(-L // _CHUNK)
    ch0 = (qg // _BLOCK_Q * _BLOCK_Q) // _CHUNK
    segs = [np.full(32, _INT_MAX, np.int32) for _ in range(_segments(k))]
    tau = r2b + 1
    queue, cnt = [], 0
    for i in range(nch):
        c0 = ((ch0 + i) % nch) * _CHUNK
        n = min(_CHUNK, L - c0)
        chunk = np.full(-(-n // 32) * 32, _INF_BITS, np.int32)
        chunk[:n] = bits[c0:c0 + n]
        cnt += int((chunk <= r2b).sum())
        for s in range(0, len(chunk), 32):
            queue += [b for j, b in enumerate(chunk[s:s + 32], c0 + s) if b < tau and j != qg]
            if len(queue) >= 32:
                tau = _list_flush(segs, queue[:32], k, r2b)
                queue = queue[32:]
    if queue:
        _list_flush(segs, queue, k, r2b)
    return np.concatenate(segs), cnt - int(bits[qg] <= r2b)


def _dense_cloud(case, rng):
    base = rng.uniform(0, 30, (1300, 3)).astype(np.float32)
    if case == "ties":        # every row twice: exact ties at the k-th distance
        pts = np.concatenate([base[:1200], base[:1200]])
    elif case == "sparse":    # mostly parked rows: fewer than k real rows
        pts = np.full((2100, 3), np.float32(knnlib.FAR), np.float32)
        pts[::150] = base[:14]
    elif case == "ragged":    # L a multiple of neither 32 nor the chunk, three chunks
        pts = base[:1300].copy()
        pts = np.concatenate([pts, rng.uniform(0, 30, (1201, 3)).astype(np.float32)])
    else:
        pts = base
    return pts[np.argsort(pts[:, 0], kind="stable")] if case != "sparse" else pts


@pytest.mark.parametrize("case", ["ties", "sparse", "self", "ragged"])
@pytest.mark.parametrize("k", [1, 20, 32, 33, 40, 64, 100, 128])
def test_dense_selection_replay_matches_plain_rows_and_pallas(case, k):
    """knn_select_kernel's stream, replayed in numpy on a sample of rows
    (every block's first and last query, and a stride), keeps the k smallest
    bit patterns; the statistic of the sorted k smallest equals the plain
    version's _knn_mean_rows and the Pallas knn_mean (interpret mode,
    unmasked) on every row it can see: the Pallas pads the cloud to a
    multiple of 128 with rows at the far point, which changes the parked
    rows' counts, so it is held on the real rows."""
    rng = np.random.default_rng(len(case) * 10 + k)
    pts = _dense_cloud(case, rng)
    L = len(pts)
    r2b = kernels._KNN_R2_BITS
    bits = _d2_bits(pts, pts)
    own = np.eye(L, dtype=bool)
    m, c = kernels._knn_mean_rows(_t(bits.view(np.float32)), _t(own), k, r2b)
    pm, pcnt = (a.numpy() for a in kernels.knn_mean(_t(pts), k))
    np.testing.assert_array_equal(pcnt, c.numpy())
    np.testing.assert_array_equal(pm, m.numpy())
    means = np.zeros(L, np.float32)
    cnts = np.zeros(L, np.int32)
    sample = set(range(0, L, 29)) | set(range(0, L, _BLOCK_Q)) | {L - 1} | set(
        range(_BLOCK_Q - 1, L, _BLOCK_Q))
    for i in range(L):
        b = np.delete(bits[i], i)
        kept = np.sort(np.where(b <= r2b, b, _INT_MAX))[:32 * _segments(k)]
        if i in sample:
            lst, cnt = _dense_stream(bits[i], i, k, r2b)
            np.testing.assert_array_equal(lst[:k], kept[:k])
            assert cnt == int((b <= r2b).sum())
        means[i] = _selection_statistic(kept, k, r2b)
        cnts[i] = int((b <= r2b).sum())
    np.testing.assert_array_equal(cnts, pcnt)
    np.testing.assert_allclose(means, pm, rtol=1e-5)
    Lp = -(-L // 128) * 128
    q8 = pk._pad8(jnp.asarray(pts), jnp.ones(L, bool), Lp)
    jm, jc = (np.asarray(a)[:L] for a in pk._knn_mean_call(
        q8, q8.T, k, pk._KNN_R2_BITS, 8, True))
    real = pts[:, 0] < knnlib.FAR
    np.testing.assert_array_equal(jc[real], cnts[real])
    np.testing.assert_allclose(jm[real], means[real], rtol=1e-5)
    few = (cnts[real] < k).mean()
    if case == "sparse":      # 14 real rows: 13 neighbours each within the cutoff
        assert real.sum() == 14 and few == (1.0 if k > 13 else 0.0)
    else:
        assert few == 0.0
    if case == "ties":        # each row's twin at d2 = 0 beside its own slot
        assert ((bits == 0).sum(1) >= 2).all()


def _nn1_sequential(d):
    """One strict-'<' scan over the base from (+inf, 0)."""
    best = np.full(d.shape[0], np.inf, np.float32)
    bj = np.zeros(d.shape[0], np.int64)
    for j in range(d.shape[1]):
        better = d[:, j] < best
        best = np.where(better, d[:, j], best)
        bj = np.where(better, j, bj)
    return bj, best


def _nn1_lanes_butterfly(d):
    """nn1_kernel's reduction: lane l scans base rows l, l + 32, ... (the
    tail padded with +inf to a whole warp step) by a strict '<' from
    (+inf, 0); then five butterfly steps take the (d2, j) lexicographic
    minimum across the lanes. Every lane must end on the same pair."""
    nq, nb = d.shape
    pad = np.full((nq, -(-nb // 32) * 32), np.inf, np.float32)
    pad[:, :nb] = d
    best = np.full((nq, 32), np.inf, np.float32)
    bj = np.zeros((nq, 32), np.int64)
    for s in range(0, pad.shape[1], 32):
        dd = pad[:, s:s + 32]
        better = dd < best
        best = np.where(better, dd, best)
        bj = np.where(better, s + np.arange(32), bj)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        od, oj = best[:, lanes ^ o], bj[:, lanes ^ o]
        take = (od < best) | ((od == best) & (oj < bj))
        best, bj = np.where(take, od, best), np.where(take, oj, bj)
    assert (bj == bj[:, :1]).all() and (best.view(np.int32) == best[:, :1].view(np.int32)).all()
    return bj[:, 0], best[:, 0]


@pytest.mark.parametrize("case", ["lattice", "all_far", "ragged"])
def test_nn1_lane_reduction_equals_sequential_scan(case):
    rng = np.random.default_rng(len(case))
    if case == "lattice":     # integer coordinates: exact ties, lowest index wins
        base = rng.integers(0, 5, (611, 3)).astype(np.float32)
        q = (rng.integers(0, 10, (333, 3)) / 2).astype(np.float32)
    elif case == "all_far":   # every base row parked: one d2 for every row
        base = np.full((517, 3), np.float32(knnlib.FAR), np.float32)
        q = rng.uniform(0, 30, (97, 3)).astype(np.float32)
    else:
        base = _lumpy(rng, 1001)
        q = _lumpy(rng, 999)
    d = _d2_bits(q, base).view(np.float32)
    sj, sd = _nn1_sequential(d)
    lj, ld = _nn1_lanes_butterfly(d)
    np.testing.assert_array_equal(lj, sj)
    np.testing.assert_array_equal(ld.view(np.int32), sd.view(np.int32))
    idx, d2 = (a.numpy()[0] for a in kernels.nn1(_t(q)[None], _t(base)[None]))
    np.testing.assert_array_equal(idx, sj)
    np.testing.assert_array_equal(d2.view(np.int32), sd.view(np.int32))
    if case == "all_far":
        assert (idx == 0).all()
    if case == "lattice":
        tied = (d == sd[:, None]).sum(1) > 1
        assert tied.mean() > 0.5
        jidx, jd2 = (np.asarray(a) for a in pk.nn1(q, base))
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(d2, jd2)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A wrapper picks the plain version by the tensor's device alone: a
    tensor on another device raises instead."""
    x = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        kernels.nn1(x, x)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        kernels.knn_mean(torch.zeros((4, 3), device="meta"), 2)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    """The register lane launches from its own thread: the counts stay exact.
    Each wrapper's launch branch runs here with the launch itself stubbed.
    (CPython's eval loop happens not to switch threads inside an attribute
    ``+=``; the lock makes the count exact by construction, not by luck.)"""
    import sys
    import threading

    monkeypatch.setattr(kernels, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(kernels, "_launch", lambda *a: None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pts = torch.zeros((64, 3), dtype=torch.float32)
    kernels.reset_launch_counts()
    n, threads = 2000, 2
    go = threading.Barrier(threads)

    def worker():
        go.wait()
        for _ in range(n):
            kernels.radius_count(pts, 1.0)

    try:
        ts = [threading.Thread(target=worker) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts["radius_count"] == threads * n
    assert sum(counts.values()) == threads * n
