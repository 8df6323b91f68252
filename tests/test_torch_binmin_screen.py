"""knn_binmin's tensor-core screen, emulated in numpy on the CPU.

The card's kernel (csrc/cloud.cu, ``knn_binmin_kernel``) cannot run here, so
these tests rebuild its arithmetic from the same pieces: the data terms and
the margin of ``kernels.binmin_screen_terms`` / ``binmin_margin``, rows and
columns centred on mu in f32, -2c' and (1 +- alpha)|c'|^2 split into bf16
hi + lo (round to nearest even by the bit pattern, as ``__float2bfloat16_rn``
rounds), the MMA's sum of the 16 exact bf16 products taken in float64 and
then moved against the screen by the accumulation error the note allows
(``kernels.BINMIN_ACC`` of the sum's absolute terms, the bound chip_smoke.py
holds the card's mma.sync to: pass 1's values down, pass 2's up),
the threshold tau rounded up as the kernel rounds it and pass 2's sum with
the accumulator -tau' (the next f32 above tau) negative, the exact confirm by
the lexicographic least (d2, j), and the exact sweep for the rows the route
sends there. On seeded adversarial clouds (duplicates, near-ties inside the
margin, a cloud 1e4 mm from the origin, parked rows and all-parked bins at
``FAR``, N not a multiple of M, M = 128 and 4096, a pixel-ordered strip of a
1080p sphere view with its plane parked) the tests show, with self-exclusion
on and off:

- every pair of a screened row meets the margin: the exact d2 lies within
  [pass 2's lower bound, pass 1's upper bound], and the observed error of
  the unperturbed screen is at most a quarter of BINMIN_ALPHA * S (the note
  derives 1.61 * 2^-15 S, a fifth);
- the confirm set of each (row, bin) holds ``knn_binmin_plain``'s winner
  and every column tied with it;
- the emulated kernel equals ``knn_binmin_plain`` bit for bit, d2 and idx.
"""
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops.knn import FAR

ALPHA, BETA = kernels.BINMIN_ALPHA, kernels.BINMIN_BETA
ACC = kernels.BINMIN_ACC  # the accumulation error the note allows, of the sum's absolute terms
FAR_NORM = 2.0 ** 126
INF = np.float32(np.inf)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split(v: np.ndarray):
    """f32 -> (hi, lo) bf16 parts; v - hi is exact in f32."""
    h = _bf16(v)
    return h, _bf16((v - h).astype(np.float32))


def _norm(v: np.ndarray) -> np.ndarray:
    """((x*x + y*y) + z*z) in f32, each step rounded (no FMA)."""
    v = v.astype(np.float32)
    return ((v[..., 0] * v[..., 0]) + (v[..., 1] * v[..., 1])) + (v[..., 2] * v[..., 2])


def _f32_up(x: np.ndarray) -> np.ndarray:
    """float64 -> the least f32 >= x."""
    f = x.astype(np.float32)
    return np.where(f.astype(np.float64) < x, np.nextafter(f, INF), f)


def _d2(q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The kernel's and the plain version's difference d2, f32: q [R, 3],
    c [N, 3] -> [R, N]."""
    d = q[:, None, :].astype(np.float32) - c[None, :, :].astype(np.float32)
    return ((d[..., 0] * d[..., 0]) + (d[..., 1] * d[..., 1])) + (d[..., 2] * d[..., 2])


def _columns(pts: np.ndarray, mu: np.ndarray):
    """The prep pass: each column's (hi + lo of -2c' [N, 3], the parts'
    absolute sum [N, 3], n+ and n- hi + lo and their absolute sums) in
    float64, the far record for a non-finite column, and |c'|^2 in f32."""
    c = (pts - mu).astype(np.float32)
    cn = _norm(c)
    ok = np.isfinite(cn)
    with np.errstate(invalid="ignore", over="ignore"):
        h, lo = _split((np.float32(-2.0) * c).astype(np.float32))
        nph, npl = _split((cn * np.float32(1 + ALPHA)).astype(np.float32))
        nmh, nml = _split((cn * np.float32(1 - ALPHA)).astype(np.float32))
    cross = np.where(ok[:, None], h.astype(np.float64) + lo, 0.0)
    cabs = np.where(ok[:, None], np.abs(h.astype(np.float64)) + np.abs(lo), 0.0)
    npos = np.where(ok, nph.astype(np.float64) + npl, FAR_NORM)
    nneg = np.where(ok, nmh.astype(np.float64) + nml, FAR_NORM)
    nposa = np.where(ok, np.abs(nph.astype(np.float64)) + np.abs(npl), FAR_NORM)
    nnega = np.where(ok, np.abs(nmh.astype(np.float64)) + np.abs(nml), FAR_NORM)
    return cross, cabs, npos, nneg, nposa, nnega, cn


def emulate(pts: np.ndarray, rows: np.ndarray, m: int, exclude_self: bool = True):
    """The kernel on numpy: (d2 f32 [R, M], idx i32 [R, M], the confirm
    mask [R, N], the screened rows [R], the largest |d2 - d2~| / S seen)."""
    pts = np.ascontiguousarray(pts, np.float32)
    n = len(pts)
    mux, muy, muz, route = kernels.binmin_screen_terms(torch.from_numpy(pts)).tolist()
    mu = np.array([mux, muy, muz], np.float32)
    cross, cabs, npos, nneg, nposa, nnega, cn = _columns(pts, mu)
    q = (pts[rows] - mu).astype(np.float32)
    qn = _norm(q)
    screened = qn <= np.float32(route)
    qh, ql = _split(q)
    qrep = qh.astype(np.float64) + ql
    qabs = np.abs(qh.astype(np.float64)) + np.abs(ql)
    dot = qrep @ cross.T                        # the cross products, exact terms summed in f64
    dabs = qabs @ cabs.T
    u = _f32_down(dot + npos[None] - ACC * (dabs + nposa[None]))
    v = _f32_up(dot + nneg[None] + ACC * (dabs + nnega[None]))
    d2 = _d2(pts[rows], pts)
    cols = np.arange(n)
    selfm = (rows[:, None] == cols[None, :]) if exclude_self else np.zeros(d2.shape, bool)
    d2 = np.where(selfm, INF, d2)
    bins = cols % m
    s = qn[:, None].astype(np.float64) + cn[None].astype(np.float64)
    fin = screened[:, None] & np.isfinite(cn)[None] & ~selfm
    upper = u + (1 + ALPHA) * qn[:, None] + BETA      # pass 1: d2 <= u + (1 + a)|q'|^2 + b
    lower = v + (1 - ALPHA) * qn[:, None] - BETA      # pass 2: d2 >= v + (1 - a)|q'|^2 - b
    assert (d2[fin] <= upper[fin]).all()
    assert (d2[fin] >= lower[fin]).all()
    tilde = dot + (cn[None].astype(np.float64) + qn[:, None])
    err = np.abs(d2.astype(np.float64) - tilde)[fin] / np.maximum(s[fin], 1e-300)
    worst = float(err.max()) if err.size else 0.0
    # pass 1: T = the least u of each (row, bin), the row itself left out
    u1 = np.where(selfm, INF, u)
    t = np.full((len(rows), m), INF, np.float32)
    np.minimum.at(t.T, bins, u1.T)
    add = _f32_up(2 * ALPHA * qn.astype(np.float64) + 2 * BETA)
    tau = _f32_up(t.astype(np.float64) + add[:, None])
    # pass 2: the MMA sums the products and the accumulator -tau' (the next
    # f32 above tau); a column passes iff that sum is negative, its
    # accumulation error counted against the screen
    tau_p = np.nextafter(tau, INF)[:, bins].astype(np.float64)
    with np.errstate(invalid="ignore"):
        hi = (dot + nneg[None] - tau_p) + ACC * (dabs + nnega[None] + np.abs(tau_p))
    confirm = screened[:, None] & ((hi < 0) | np.isinf(tau_p))
    # the confirm: lexicographic least (d2, j) over the confirmed columns,
    # from (+inf, b); then a NaN first column, which the plain version keeps
    out_d = np.full((len(rows), m), INF, np.float32)
    out_i = np.tile(np.arange(m, dtype=np.int32), (len(rows), 1))
    key_d = np.where(confirm & ~np.isnan(d2), d2, INF)
    for b in range(m):
        blk = key_d[:, b::m]
        j = np.argmin(blk, axis=1)                # the first least: the lowest j on ties
        best = blk[np.arange(len(rows)), j]
        win = best < INF
        out_d[win, b] = best[win]
        out_i[win, b] = b + m * j[win]
    first = np.isnan(d2[:, :m]) & screened[:, None]
    out_d[first], out_i[first] = d2[:, :m][first], np.nonzero(first)[1]
    # the exact sweep of the rows the screen does not serve: from each bin's
    # first column, a strict '<' over the rest in rising order
    for r in np.flatnonzero(~screened):
        for b in range(m):
            col = d2[r, b::m]
            bd, bj = col[0], b
            for t in range(1, len(col)):
                if col[t] < bd:
                    bd, bj = col[t], b + m * t
            out_d[r, b], out_i[r, b] = bd, bj
    return out_d, out_i, confirm, screened, worst, d2


def _f32_down(x: np.ndarray) -> np.ndarray:
    """float64 -> the greatest f32 <= x."""
    f = x.astype(np.float32)
    return np.where(f.astype(np.float64) > x, np.nextafter(f, -INF), f)


def _check(pts, rows, m, exclude_self=True):
    """The emulated kernel against knn_binmin_plain: bit for bit, the
    winner and its ties confirmed; returns (confirms a screened (row, bin),
    screened rows, worst relative screen error)."""
    pts = np.ascontiguousarray(pts, np.float32)
    rows = np.asarray(rows, np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        d, i, confirm, screened, worst, d2 = emulate(pts, rows, m, exclude_self)
    pd, pi = kernels.knn_binmin_plain(torch.from_numpy(pts), torch.from_numpy(rows), m,
                                      exclude_self)
    pd, pi = pd.numpy(), pi.numpy()
    # bit for bit; a NaN as a NaN (numpy and torch may carry other payloads)
    nan = np.isnan(pd)
    np.testing.assert_array_equal(np.isnan(d), nan)
    np.testing.assert_array_equal(d.view(np.int32)[~nan], pd.view(np.int32)[~nan])
    np.testing.assert_array_equal(i, pi)
    # the winner and every column tied with it passed the screen
    n = len(pts)
    bins = np.arange(n) % m
    fin = np.isfinite(pd)
    tied = (d2 == pd[:, bins]) & fin[:, bins]
    assert confirm[screened[:, None] & tied].all()
    per_bin = float(confirm[screened].sum()) / max(1, int(screened.sum()) * m)
    assert worst <= ALPHA / 4, worst
    return per_bin, int(screened.sum()), worst


def _cloud(n, seed, scale=50.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_duplicates_tie_to_the_lowest_index(exclude_self):
    rng = np.random.default_rng(1)
    base = _cloud(1000, 1)
    pts = base[rng.integers(0, len(base), 3000)]      # every point about three times
    rows = rng.choice(len(pts), 256, replace=False)
    per_bin, scr, _ = _check(pts, rows, 128, exclude_self)
    assert scr == len(rows)


def test_near_ties_inside_the_margin():
    """Columns of one bin at squared distances that differ by less than the
    margin from the query: all confirmed, the exact least (lowest j on ties)
    wins."""
    rng = np.random.default_rng(2)
    m, n = 128, 4096
    pts = _cloud(n, 2, scale=100.0)
    rows = np.arange(0, n, 64)
    for r in rows:
        q = pts[r].astype(np.float64)
        b = (r + 5) % m
        js = np.arange(b, n, m)[rng.choice(n // m, 8, replace=False)]
        js = js[js != r]
        s = float(np.sum((q - pts.mean(0)) ** 2)) + 100.0 ** 2
        eps = ALPHA * s
        d0 = 900.0
        for k, j in enumerate(js):
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            pts[j] = (q + direction * np.sqrt(d0 + (k % 4) * eps / 8)).astype(np.float32)
    per_bin, scr, _ = _check(pts, rows, m)
    assert scr == len(rows)


def test_cloud_far_from_the_origin():
    """1e4 mm from the origin: the centroid keeps the screen's norms small."""
    pts = _cloud(6000, 3, scale=40.0, offset=1e4)
    rows = np.random.default_rng(3).choice(len(pts), 200, replace=False)
    per_bin, scr, worst = _check(pts, rows, 256)
    assert scr == len(rows) and per_bin < 1.1       # the winner, rarely another


@pytest.mark.parametrize("exclude_self", [True, False])
def test_parked_rows_and_all_parked_bins(exclude_self):
    """A tile of parked query rows (the exact sweep: every parked column ties
    at 0, the lowest wins) and bins whose every column is parked (every
    column of the bin ties: the screen confirms them all)."""
    rng = np.random.default_rng(4)
    m, n = 128, 5000                                  # N not a multiple of M
    pts = _cloud(n, 4)
    parked = rng.random(n) < 0.3
    parked[np.isin(np.arange(n) % m, [5, 6, 77])] = True
    pts[parked] = FAR
    rows = np.concatenate([np.flatnonzero(parked)[:64], np.flatnonzero(~parked)[:192]])
    per_bin, scr, _ = _check(pts, rows, m, exclude_self)
    assert scr == 192                                 # the parked rows took the exact sweep


@pytest.mark.parametrize("m", [128, 4096])
def test_bin_counts_at_both_ends(m):
    pts = _cloud(9001, 5, scale=80.0)
    rows = np.random.default_rng(5).choice(len(pts), 96, replace=False)
    _check(pts, rows, m)


def test_non_finite_columns_and_rows():
    """inf and NaN coordinates never win, as in the plain version; a
    non-finite row takes the exact sweep."""
    pts = _cloud(2000, 6)
    pts[[3, 130, 257]] = np.inf
    pts[[4, 900]] = np.nan
    rows = np.array([3, 4, 10, 11, 12, 500, 1999])
    per_bin, scr, _ = _check(pts, rows, 128)
    assert scr == 5


def _sphere_strip(rows_from=520, height=12, width=1920):
    """Pixel-ordered points of a 1080p camera looking at the canonical scene
    (a 70 mm sphere 420 mm away before a wall at 560 mm), image rows
    [rows_from, rows_from + height); the wall parked at FAR, as the cluster
    step parks the plane's inliers."""
    f, cx, cy = 1400.0, (width - 1) / 2, 539.5
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(rows_from, rows_from + height, dtype=np.float64))
    d = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.array([0.0, 0.0, 420.0])
    b = d @ c
    disc = b * b - (c @ c - 70.0 ** 2)
    hit = disc > 0
    t = np.where(hit, b - np.sqrt(np.maximum(disc, 0)), 560.0 / d[:, 2])
    pts = (d * t[:, None]).astype(np.float32)
    pts[~hit] = FAR
    return pts, hit


def test_pixel_ordered_1080p_strip():
    """The cluster step's shape in miniature: the sphere's pixels among the
    parked wall, k = 16 at recall 0.99 (M = 2048), query rows over the
    whole strip (parked ones take the exact sweep)."""
    pts, hit = _sphere_strip()
    n = len(pts)
    m = kernels.binmin_bins(10 ** 6, 16, 0.99)
    rows = np.arange(0, n, 61)
    per_bin, scr, worst = _check(pts, rows, m)
    assert scr == int(hit[rows].sum())
    # the winner, and in the bins the strip's 12 image rows leave all parked
    # (tied at one d2) every column
    assert per_bin < 2.5, per_bin


def test_screen_terms_route_parked_and_huge_clouds():
    pts = _cloud(500, 7, offset=1e4)
    pts[:50] = FAR
    terms = kernels.binmin_screen_terms(torch.from_numpy(pts))
    assert terms.dtype == torch.float32 and terms.shape == (4,)
    mx, my, mz, route = terms.tolist()
    mu = pts[50:].astype(np.float64).mean(0)
    np.testing.assert_allclose([mx, my, mz], mu, rtol=1e-6)
    r2 = ((pts[50:] - np.float32([mx, my, mz])) ** 2).sum(1).max()
    assert 16 * r2 <= route <= 16 * r2 * (1 + 1e-5)
    assert (_norm(pts[:50] - np.float32([mx, my, mz])) > route).all()
    huge = pts.copy()
    huge[7, 1] = 2.0 ** 61
    assert kernels.binmin_screen_terms(torch.from_numpy(huge))[3] == -1.0
    assert kernels.binmin_screen_terms(torch.full((8, 3), FAR))[3] == -1.0
    assert kernels.binmin_screen_terms(torch.zeros((0, 3)))[3] == -1.0
    assert kernels.binmin_margin(3.0, 5.0) == ALPHA * 8.0 + BETA


def test_mma_probe_plain_version_is_the_float64_sum():
    """binmin_mma_probe on the CPU: a bt^T + c summed in float64 (bf16
    products are exact there) and rounded once, the reference chip_smoke.py
    holds the card's mma.sync against."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(4, 16, 16)).astype(np.float32)).bfloat16()
    bt = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32)).bfloat16()
    c = torch.from_numpy(rng.normal(size=(4, 16, 8)).astype(np.float32))
    d = kernels.binmin_mma_probe(a, bt, c)
    assert d.dtype == torch.float32 and d.shape == (4, 16, 8)
    want = (np.einsum("tmk,tnk->tmn", a.float().numpy().astype(np.float64),
                      bt.float().numpy().astype(np.float64)) + c.numpy()).astype(np.float32)
    np.testing.assert_array_equal(d.numpy(), want)


def test_ctypes_signatures_match_the_c_entries():
    """Every ``slscan_*`` entry of csrc/*.cu has its ctypes argtypes, one a
    parameter, the stream included (an argument past the list would pass as
    a 32-bit int and cut a pointer): pointers and the stream c_void_p,
    float c_float, long long c_longlong, int c_int."""
    import ctypes
    import glob
    import os
    import re

    csrc = os.path.join(os.path.dirname(kernels.__file__), "csrc")
    seen = set()
    for src in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        text = open(src).read()
        for m in re.finditer(r"^int (slscan_\w+)\(([^)]*)\)\s*\{", text, re.M):
            name, params = m.group(1), [p.strip() for p in m.group(2).split(",")]
            want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                    else ctypes.c_float if p.startswith("float")
                    else ctypes.c_longlong if p.startswith("long long")
                    else ctypes.c_int for p in params]
            assert kernels._SIGNATURES[name] == want, name
            seen.add(name)
    assert seen == set(kernels._SIGNATURES)
