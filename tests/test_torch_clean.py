"""The port's clean chain against the JAX package, on the CPU.

Clouds are made with numpy from a seed. Tolerances:

- radius_count's kernel form (every base row counted in grid.y spans, the
  query's own term d2(q, q) <= r^2 subtracted) equals the plain version's
  index compare exactly, parked, duplicated and NaN rows included.
- radius_count (the plain version, what CPU tensors take) against the JAX
  package's cKDTree twin radius_count_np, its dense _radius_blocks and its
  Pallas radius_count_pallas (interpret mode on the CPU): counts equal on
  every valid row that has no pair whose float64 d^2 lies within 1e-2 r^2
  of r^2. The port compares d^2 by coordinate differences in f32, the
  cKDTree in float64 and the JAX kernels on the f32 expansion
  |q|^2+|b|^2-2q.b, so a pair in that band may fall either way; such rows
  are excluded, counted, and must be under 1 % of the rows. The test cloud
  is a jittered lattice (squared distances near integers, far from r^2),
  plus sparse scattered points and invalid rows parked at 1e9.
- segment_plane fed the JAX package's jax.random.choice draws: the same
  winning hypothesis (plane within 1e-5), inliers equal on every row whose
  float64 distance to the plane is more than 1e-3 mm from the 2 mm band
  edge (the score product sums in another order).
- cluster_labels / largest_cluster_mask: labels equal (separated blobs,
  no near-tied neighbours at the eps edge).
- clean_chain with scaled CleanConfig values and the JAX draws injected:
  masks and counts equal; _clean_arrays' counts equal to the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.ops import knn as jknn
from structured_light_for_3d_model_replication_tpu.ops import pallas_kernels as pk
from structured_light_for_3d_model_replication_tpu.ops import pointcloud as jpc
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.ops import kernels
from structured_light_for_3d_model_replication_tpu_torch.ops import knn as knnlib
from structured_light_for_3d_model_replication_tpu_torch.ops import pointcloud as pc
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

FAR = 1e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tensors are small: beside the other test workers on the box,
    torch's default thread pool oversubscribes the cores and runs them many
    times slower, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice_cloud(seed: int = 0, n_invalid: int = 40):
    """A 12^3 lattice of spacing 1 jittered by +-0.002, 100 scattered points
    around it, and invalid rows parked at 1e9 -> (points [N, 3] f32, valid)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(12.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = g + rng.uniform(-0.002, 0.002, g.shape)
    scat = rng.uniform(-30.0, 40.0, (100, 3))
    pts = np.concatenate([lat, scat]).astype(np.float32) - np.float32(6.0)
    pts = pts[rng.permutation(len(pts))]
    valid = np.ones(len(pts) + n_invalid, bool)
    valid[len(pts):] = False
    pts = np.concatenate([pts, np.full((n_invalid, 3), FAR, np.float32)])
    return pts, valid


def _band_rows(pts, valid, r):
    """Valid rows with a valid partner whose float64 d^2 is within
    1e-2 r^2 of r^2."""
    p = pts.astype(np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    band = (np.abs(d2 - r * r) <= 1e-2 * r * r) & valid[None, :] & valid[:, None]
    np.fill_diagonal(band, False)
    return band.any(1)


def _jax_radius_blocks(pts, valid, r):
    n = len(pts)
    bq, bb, n_pad = jknn._choose_blocks(n, 512, 8192)
    p, v = jknn._pad_jax(jnp.asarray(pts), jnp.asarray(valid), n_pad)
    return np.asarray(jknn._radius_blocks(p, v, jnp.float32(r), bq, bb, True))[:n]


@pytest.mark.parametrize("r", [1.5, 2.5, 3.2])
@pytest.mark.parametrize("reference", ["radius_count_np", "_radius_blocks",
                                       "radius_count_pallas"])
def test_radius_count_matches_the_jax_package(r, reference):
    pts, valid = _lattice_cloud()
    ours = knnlib.radius_count(torch.from_numpy(pts), torch.from_numpy(valid), r).numpy()
    if reference == "radius_count_np":
        ref = jknn.radius_count_np(pts, valid, r)
    elif reference == "_radius_blocks":
        ref = _jax_radius_blocks(pts, valid, r)
    else:
        assert not pk.use_pallas()   # the CPU runs the kernel in interpret mode
        ref = np.asarray(pk.radius_count_pallas(pts, valid, r))
    band = _band_rows(pts, valid, r)
    assert band.sum() < 0.01 * len(pts)
    keep = valid & ~band
    assert keep.sum() > 1700 and ours[keep].max() >= 18
    np.testing.assert_array_equal(ours[keep], ref[keep])


def test_radius_count_plain_counts_self_by_flag_and_parks_invalid_rows():
    pts, valid = _lattice_cloud(1)
    p, v = torch.from_numpy(pts), torch.from_numpy(valid)
    ex = knnlib.radius_count(p, v, 2.5)
    inc = knnlib.radius_count(p, v, 2.5, exclude_self=False)
    assert torch.equal(inc, ex + 1)
    # parked rows are nobody's neighbour: dropping them changes no valid count
    kept = knnlib.radius_count(p[v], torch.ones(int(v.sum()), dtype=torch.bool), 2.5)
    assert torch.equal(ex[v], kept)
    assert kernels.radius_count(torch.zeros((0, 3)), 1.0).shape == (0,)


def _radius_count_by_spans(pts: torch.Tensor, r: float, span: int) -> torch.Tensor:
    """radius_count as the kernel takes it: per base span, every row with
    d2 <= r^2 counted (no index compare), the query's own term d2(q, q) <= r^2
    subtracted where the span holds it, the partials summed."""
    n = pts.shape[0]
    r2 = kernels._sq_f32(r)
    rows = torch.arange(n)
    own = knnlib.sq_dist(pts, pts) <= r2            # d2(q, q): 0, or NaN on a NaN row
    out = torch.zeros(n, dtype=torch.int32)
    for b0 in range(0, n, span):
        part = (knnlib.sq_dist(pts[:, None, :], pts[None, b0:b0 + span, :]) <= r2).sum(1)
        part = part - (own & (rows >= b0) & (rows < b0 + span)).to(part.dtype)
        out += part.to(torch.int32)
    return out


def _twin_cloud(seed):
    pts, _ = _lattice_cloud(seed)
    return np.concatenate([pts[:900], pts[:900], pts[-40:]])


def _nan_cloud(seed):
    pts, _ = _lattice_cloud(seed)
    pts = pts.copy()
    pts[[5, 77]] = np.nan
    return pts


@pytest.mark.parametrize("cloud,r,span", [("lattice", 2.5, 256), ("lattice", 1.0, 700),
                                          ("twins", 1.5, 256), ("nan", 2.5, 512)])
def test_radius_count_self_term_equals_index_compare(cloud, r, span):
    pts = {"lattice": lambda s: _lattice_cloud(s)[0], "twins": _twin_cloud,
           "nan": _nan_cloud}[cloud](3)
    p = torch.from_numpy(np.ascontiguousarray(pts))
    ref = kernels.radius_count_plain(p, r)
    got = _radius_count_by_spans(p, r, span)
    assert torch.equal(got, ref)
    if cloud == "twins":
        assert bool((ref[:900] >= 1).all())        # each row's twin at d2 = 0
    if cloud == "nan":
        assert int(ref[5]) == 0 and int(ref[77]) == 0
    assert bool((ref[-40:] == 39).all())          # the 40 parked rows coincide


def _plane_cloud(seed=0, n_plane=1500, n_obj=700, n_pad=300):
    """A floor plane y = 20 (0.3 mm noise) under a sphere, padded with rows
    at 1e9 -> (points, valid)."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(-60, 60, n_plane), 20 + rng.normal(0, 0.3, n_plane),
                  rng.uniform(-60, 60, n_plane)]
    d = rng.normal(size=(n_obj, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    obj = d * 15.0 + np.array([0.0, 0.0, 5.0])
    pts = np.concatenate([floor, obj, np.full((n_pad, 3), FAR)]).astype(np.float32)
    valid = np.arange(len(pts)) < n_plane + n_obj
    return pts, valid


def _jax_draws(valid, trials):
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(valid),
                                        shape=(trials, 3), p=probs))


def test_segment_plane_with_the_jax_draws():
    pts, valid = _plane_cloud()
    plane_j, inl_j = jpc.segment_plane(jnp.asarray(pts), jnp.asarray(valid), 2.0, 256)
    plane_t, inl_t = pc.segment_plane(torch.from_numpy(pts), torch.from_numpy(valid), 2.0,
                                      256, samples=_jax_draws(valid, 256))
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), atol=1e-5)
    pl = np.asarray(plane_j, np.float64)
    dist = np.abs(pts.astype(np.float64) @ pl[:3] + pl[3])
    away = np.abs(dist - 2.0) > 1e-3
    np.testing.assert_array_equal(inl_t.numpy()[away], np.asarray(inl_j)[away])
    assert inl_t.numpy()[valid].sum() > 1400 and not inl_t.numpy()[~valid].any()


def test_segment_plane_draws_never_hit_padding():
    _, valid = _plane_cloud(1)
    s = pc._plane_samples(torch.from_numpy(valid), 512)
    assert s.shape == (512, 3) and bool(torch.from_numpy(valid)[s].all())
    assert torch.equal(s, pc._plane_samples(torch.from_numpy(valid), 512))


def _blobs(seed=0):
    """Three Gaussian blobs of 400, 250 and 120 points, 40 mm apart, 30
    scattered noise points and 100 padding rows."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(c, 2.0, (m, 3)) for c, m in
             (((0, 0, 0), 400), ((40, 0, 0), 250), ((0, 40, 0), 120))]
    parts.append(rng.uniform(-30, 70, (30, 3)))
    pts = np.concatenate(parts + [np.full((100, 3), FAR)]).astype(np.float32)
    perm = np.r_[rng.permutation(800), np.arange(800, 900)]
    pts = pts[perm]
    return pts, np.arange(900) < 800


@pytest.mark.parametrize("eps,min_points", [(2.0, 8), (3.0, 20)])
def test_cluster_labels_equal_the_jax_package(eps, min_points):
    pts, valid = _blobs()
    lab_j = np.asarray(jpc.cluster_labels(jnp.asarray(pts), jnp.asarray(valid), eps,
                                          min_points))
    lab_t = pc.cluster_labels(torch.from_numpy(pts), torch.from_numpy(valid), eps,
                              min_points).numpy()
    np.testing.assert_array_equal(lab_t, lab_j)
    assert len(np.unique(lab_t[lab_t >= 0])) >= 3
    m_j = np.asarray(jpc.largest_cluster_mask(jnp.asarray(pts), jnp.asarray(valid), eps,
                                              min_points))
    m_t = pc.largest_cluster_mask(torch.from_numpy(pts), torch.from_numpy(valid), eps,
                                  min_points).numpy()
    np.testing.assert_array_equal(m_t, m_j)
    assert 300 < m_t.sum() <= 400


def _scaled(cfg):
    cfg.plane_ransac_trials = 128
    cfg.cluster_eps, cfg.cluster_min_points = 4.0, 10
    cfg.radius, cfg.radius_nb_points = 4.0, 6
    return cfg


def _scene_cloud(seed=0):
    """A floor, two objects (the sphere of _plane_cloud and a far blob),
    scattered outliers and padding: every step removes something."""
    pts, valid = _plane_cloud(seed, n_plane=1200, n_obj=900, n_pad=0)
    rng = np.random.default_rng(seed + 7)
    extra = np.concatenate([rng.normal((70, 0, 0), 2.5, (150, 3)),
                            rng.uniform(-60, 60, (40, 3))]).astype(np.float32)
    pts = np.concatenate([pts[valid], extra])
    n = len(pts)
    bucket = -(-n // 2048) * 2048
    pad = np.full((bucket, 3), FAR, np.float32)
    pad[:n] = pts
    return pad, np.arange(bucket) < n


def test_clean_chain_equals_the_jax_package():
    pts, valid = _scene_cloud()
    m_j, c_j = jpc.clean_chain(jnp.asarray(pts), jnp.asarray(valid),
                               _scaled(jconfig.CleanConfig()))
    m_t, c_t = pc.clean_chain(torch.from_numpy(pts), torch.from_numpy(valid),
                              _scaled(config.CleanConfig()),
                              samples=_jax_draws(valid, 128))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    c = c_t.numpy()
    assert valid.sum() > c[0] > c[1] > c[2] >= c[3] > 500, c


def test_clean_arrays_counts_equal_the_jax_package():
    pts, valid = _scene_cloud(1)
    pts = pts[valid]
    cols = np.full(pts.shape, 90, np.uint8)
    jcfg, tcfg = jconfig.Config(), config.Config()
    _scaled(jcfg.clean)
    _scaled(tcfg.clean)
    steps = ("cluster", "radius", "statistical")   # no draws: equal without injection
    p_j, _, cnt_j = jstages._clean_arrays(pts, cols, jcfg, steps)
    p_t, c_t, cnt_t = stages._clean_arrays(pts, cols, tcfg, steps, device="cpu")
    assert cnt_t == cnt_j and len(cnt_t) == 4
    np.testing.assert_array_equal(p_t, p_j)
    assert c_t.shape == p_t.shape


def test_empty_cloud_and_disabled_background():
    cfg = config.Config()
    masks, counts = pc.clean_chain(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool),
                                   cfg.clean)
    assert masks.shape == (4, 0) and counts.tolist() == [0, 0, 0, 0]
    # an empty view: padded to one bucket of parked rows, aborted at step one
    p, c, cnt = stages._clean_arrays(np.zeros((0, 3), np.float32),
                                     np.zeros((0, 3), np.uint8), cfg, device="cpu")
    assert p.shape == (0, 3) and cnt == {"input": 0, "background": 0}
    cfg.clean.remove_background_plane = False
    params = pc.chain_params(cfg.clean)
    assert [s for s, _ in params] == ["cluster", "radius", "statistical"]
    assert pc.chain_params(cfg.clean, ("background",)) == ()
    assert pc.chain_params(cfg.clean, ("background",)) == jpc.chain_params(
        jconfig.Config(clean=jconfig.CleanConfig(remove_background_plane=False)).clean,
        ("background",))
    pts = np.random.default_rng(0).normal(0, 1, (50, 3)).astype(np.float32)
    p, _, cnt = stages._clean_arrays(pts, np.zeros((50, 3), np.uint8), cfg, ("background",),
                                     device="cpu")
    assert cnt == {"input": 50} and len(p) == 50
    with pytest.raises(ValueError, match="unknown clean step"):
        pc.chain_params(cfg.clean, ("denoise",))


def test_all_removed_aborts_the_chain_like_the_jax_package():
    pts, valid = _scene_cloud(2)
    pts = pts[valid]
    cols = np.zeros(pts.shape, np.uint8)
    jcfg, tcfg = jconfig.Config(), config.Config()
    for c in (jcfg.clean, tcfg.clean):
        _scaled(c)
        c.cluster_min_points = 10_000   # no core point: the cluster step empties the cloud
    steps = ("cluster", "radius", "statistical")
    p_t, _, cnt_t = stages._clean_arrays(pts, cols, tcfg, steps, device="cpu")
    _, _, cnt_j = jstages._clean_arrays(pts, cols, jcfg, steps)
    assert cnt_t == cnt_j == {"input": len(pts), "cluster": 0}
    assert p_t.shape == (0, 3)


def test_segment_plane_scores_degenerate_triples_zero():
    """A triple with a repeated row spans no plane. The JAX package's
    scoring gives it a zero normal, so every valid row lies within the
    threshold and it wins: the background step would remove the whole view
    (a reference-side fault, ROADMAP C). The port scores it 0 and keeps the
    real plane."""
    pts, valid = _plane_cloud(3)
    floor = np.flatnonzero(valid)[:3]          # three floor rows: a real plane
    samples = np.array([[5, 5, 900], floor])
    p = jnp.asarray(pts)
    n_j, d_j = jpc._plane_from_triples(*(p[samples[:, i]] for i in range(3)), jnp)
    score_j = ((jnp.abs(p @ n_j.T + d_j) <= 2.0) & jnp.asarray(valid)[:, None]).sum(0)
    assert int(jnp.argmax(score_j)) == 0 and int(score_j[0]) == valid.sum()
    plane, inl = pc.segment_plane(torch.from_numpy(pts), torch.from_numpy(valid), 2.0,
                                  2, samples=samples)
    assert abs(abs(float(plane[1])) - 1.0) < 1e-2      # the noisy floor: normal ~ +-y
    assert int(inl.sum()) > 300 and not inl[1500:].any()   # floor rows only


def test_clean_cli_on_a_file_and_a_folder(tmp_path):
    """``clean`` on one PLY equals _clean_arrays; on a folder it cleans each
    PLY into the output folder."""
    from structured_light_for_3d_model_replication_tpu_torch import cli
    from structured_light_for_3d_model_replication_tpu_torch.io import ply

    pts, valid = _scene_cloud(3)
    pts = pts[valid]
    cols = np.full(pts.shape, 77, np.uint8)
    src = tmp_path / "in"
    src.mkdir()
    for name in ("a.ply", "b.ply"):
        ply.write_ply(str(src / name), pts, cols)
    sets = []
    for k, v in (("clean.cluster_eps", 4.0), ("clean.cluster_min_points", 10),
                 ("clean.radius", 4.0), ("clean.radius_nb_points", 6)):
        sets += ["--set", f"{k}={v}"]
    steps = ["--steps", "cluster,radius,statistical", "--device", "cpu"]
    assert cli.main(["clean", str(src / "a.ply"), str(tmp_path / "a_out.ply")] + steps
                    + sets) == 0
    cfg = config.Config()
    _scaled(cfg.clean)
    want, _, _ = stages._clean_arrays(pts, cols, cfg, ("cluster", "radius", "statistical"),
                                      device="cpu")
    got = ply.read_ply(str(tmp_path / "a_out.ply"))
    np.testing.assert_array_equal(got["points"], want)
    assert (got["colors"] == 77).all()
    assert cli.main(["clean", str(src), str(tmp_path / "out")] + steps + sets) == 0
    for name in ("a.ply", "b.ply"):
        np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "out" / name))["points"],
                                      want)
