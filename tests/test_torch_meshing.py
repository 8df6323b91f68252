"""The port's meshing against the JAX package, on the CPU.

Inputs are a noisy sphere with its radial normals, made with numpy from a
seed. Tolerances:

- poisson_solve at depth 5: chi within 1e-5 of the JAX package's (|chi|
  ~1; the splat sums in float64 and the CG's dot products in torch's
  order), the density within 1e-5, the iso level within 1e-6;
- extract_surface fed the JAX package's chi: vertices and faces equal;
- poisson_solve_bricks at depth 6 on a depth-4 base: the same bricks, iso
  within 1e-5, and the extracted surfaces within 1 % of a fine cell of each
  other (symmetric mean nearest-vertex distance), vertex counts equal;
- orient_normals: equal (signs of the same dot products);
- reconstruct_mesh end to end: vertex count within 1 % of the JAX
  package's, chamfer distance between the meshes' vertices under half a
  cell;
- the STL and the mesh PLY: the same bytes as the JAX package's writers
  for the same arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.io import stl as jstl
from structured_light_for_3d_model_replication_tpu.models import meshing as jmeshing
from structured_light_for_3d_model_replication_tpu.ops import normals as jnormals
from structured_light_for_3d_model_replication_tpu.ops import poisson as jpoisson
from structured_light_for_3d_model_replication_tpu.ops import poisson_bricks as jbricks
from structured_light_for_3d_model_replication_tpu.ops import surface_nets as jsn
from structured_light_for_3d_model_replication_tpu_torch import config
from structured_light_for_3d_model_replication_tpu_torch.io import ply, stl
from structured_light_for_3d_model_replication_tpu_torch.models import meshing
from structured_light_for_3d_model_replication_tpu_torch.ops import meshproc
from structured_light_for_3d_model_replication_tpu_torch.ops import normals
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson_bricks
from structured_light_for_3d_model_replication_tpu_torch.ops import surface_nets

QUIET = dict(log=lambda *a: None)
CENTER = np.array([5.0, -3.0, 400.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tensors are small: beside the other test workers on the box,
    torch's default thread pool oversubscribes the cores and runs them many
    times slower, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(n=4000, radius=40.0, noise=0.2, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * (radius + rng.normal(0, noise, (n, 1))) + CENTER
    return pts.astype(np.float32), d.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("depth", [5, 6])
def test_poisson_solve_matches_the_jax_package(depth):
    pts, nrm = _sphere()
    valid = np.ones(len(pts), bool)
    valid[::50] = False
    rj = jpoisson.poisson_solve(pts, nrm, valid, depth=depth)
    rt = poisson.poisson_solve(_t(pts), _t(nrm), _t(valid), depth=depth)
    np.testing.assert_allclose(rt.chi.numpy(), np.asarray(rj.chi), atol=1e-5)
    np.testing.assert_allclose(rt.density.numpy(), np.asarray(rj.density), atol=1e-5)
    assert abs(float(rt.iso) - float(rj.iso)) < 1e-6
    np.testing.assert_allclose(rt.origin.numpy(), np.asarray(rj.origin), rtol=1e-6)
    assert float(rt.cell) == pytest.approx(float(rj.cell), rel=1e-6)
    with pytest.raises(ValueError, match="depth 10 > 9"):
        poisson.poisson_solve(_t(pts), _t(nrm), depth=10)


def test_extract_surface_on_the_jax_field_is_identical():
    pts, nrm = _sphere(seed=1)
    rj = jpoisson.poisson_solve(pts, nrm, None, depth=6)
    kw = dict(origin=np.asarray(rj.origin), cell=float(rj.cell))
    vj, fj = jsn.extract_surface(rj.chi, float(rj.iso), **kw)
    vt, ft = surface_nets.extract_surface(_t(np.asarray(rj.chi)), float(rj.iso), **kw)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    out_j = jsn.extract_surface(rj.chi, float(rj.iso), face_cells=True)
    out_t = surface_nets.extract_surface(np.asarray(rj.chi), float(rj.iso), face_cells=True)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert len(ft) > 1000


def test_poisson_solve_bricks_matches_the_jax_package():
    pts, nrm = _sphere(n=6000, seed=2)
    kw = dict(depth=6, base_depth=4, brick=8, halo=4, batch=8)
    rj = jbricks.poisson_solve_bricks(pts, nrm, None, **kw)
    rt = poisson_bricks.poisson_solve_bricks(_t(pts), _t(nrm), None, **kw)
    assert rt.n_bricks == rj.n_bricks > 100
    np.testing.assert_array_equal(rt.brick_lo, rj.brick_lo)
    assert abs(rt.iso - rj.iso) < 1e-5
    vj, fj = jbricks.extract_surface_bricks(rj)
    vt, ft = poisson_bricks.extract_surface_bricks(rt)
    assert len(vt) == len(vj) and len(ft) == len(fj)
    assert _chamfer(vt, vj) < 0.01 * rt.cell
    r = np.linalg.norm(vt - CENTER, axis=1)
    assert abs(r.mean() - 40.0) < 0.5
    with pytest.raises(ValueError, match="base_depth"):
        poisson_bricks.poisson_solve_bricks(_t(pts), _t(nrm), depth=4, base_depth=4)


@pytest.mark.parametrize("mode,flip", [("radial", False), ("centroid", True)])
def test_orient_normals_matches_the_jax_package(mode, flip):
    pts, nrm = _sphere(seed=3)
    rng = np.random.default_rng(3)
    mixed = (nrm * rng.choice([-1.0, 1.0], (len(nrm), 1))).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[:100] = False
    oj = np.asarray(jnormals.orient_normals(jnp.asarray(pts), jnp.asarray(mixed),
                                            jnp.asarray(valid), mode=mode, flip=flip))
    ot = normals.orient_normals(_t(pts), _t(mixed), _t(valid), mode=mode, flip=flip)
    np.testing.assert_array_equal(ot.numpy(), oj)
    with pytest.raises(ValueError, match="orientation mode"):
        normals.orient_normals(_t(pts), _t(mixed), _t(valid), mode="tangent")


def test_reconstruct_mesh_end_to_end_matches_the_jax_package():
    pts, _ = _sphere(n=5000, seed=4)
    jcfg = jconfig.MeshConfig(depth=6)
    tcfg = config.MeshConfig(depth=6)
    vj, fj = jmeshing.reconstruct_mesh(pts, None, None, cfg=jcfg, **QUIET)
    vt, ft = meshing.reconstruct_mesh(pts, None, None, cfg=tcfg, device="cpu", **QUIET)
    vj, fj = np.asarray(vj), np.asarray(fj)
    assert abs(len(vt) - len(vj)) <= 0.01 * len(vj) and len(vt) > 1000
    cell = 80.0 * 1.16 / 64
    assert _chamfer(vt, vj) < 0.5 * cell
    assert meshproc.mesh_volume(vt, ft) > 0   # outward winding
    tcfg.mode = "surface"
    with pytest.raises(NotImplementedError, match="A9"):
        meshing.reconstruct_mesh(pts, cfg=tcfg, device="cpu", **QUIET)


def test_stl_and_mesh_ply_bytes_equal_the_jax_writers(tmp_path):
    rng = np.random.default_rng(5)
    verts = rng.normal(0, 10, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (500, 3)).astype(np.int32)
    stl.write_stl(str(tmp_path / "t.stl"), verts, faces)
    jstl.write_stl(str(tmp_path / "j.stl"), verts, faces)
    assert (tmp_path / "t.stl").read_bytes() == (tmp_path / "j.stl").read_bytes()
    v, f, n = stl.read_stl(str(tmp_path / "j.stl"))
    np.testing.assert_array_equal(v.reshape(-1, 3, 3), verts[faces])
    ply.write_mesh_ply(str(tmp_path / "t.ply"), verts, faces)
    jply.write_mesh_ply(str(tmp_path / "j.ply"), verts, faces)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = jply.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(back["faces"], faces)
    np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "t.ply"))["points"], verts)


def test_depth_policy_on_the_cpu():
    """The density cap lowers the depth (50 points: cap 4); depth 10 on the
    CPU steps down to dense 9 unless the cap is off (not run: 512^3)."""
    pts, nrm = _sphere(n=50, seed=6)
    t, v = _t(pts), torch.ones(len(pts), dtype=torch.bool)
    msgs = []
    res = meshing._poisson_dispatch(t, _t(nrm), v, 10, msgs.append)
    assert isinstance(res, poisson.PoissonResult) and res.chi.shape[0] == 16
    assert "depth 10 -> 4" in msgs[0]
    calls = []

    def fake_dense(*a, depth, **k):
        calls.append(("dense", depth))
        raise StopIteration

    def fake_bricks(*a, depth, **k):
        calls.append(("bricks", depth))
        raise StopIteration

    big = torch.zeros(1 << 20, dtype=torch.bool)
    big[:] = True
    for cap_on in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(poisson, "poisson_solve", fake_dense)
            mp.setattr(poisson_bricks, "poisson_solve_bricks", fake_bricks)
            with pytest.raises(StopIteration):
                meshing._poisson_dispatch(torch.zeros((1 << 20, 3)), torch.zeros((1 << 20, 3)),
                                          big, 10, msgs.append, density_cap=cap_on)
    assert calls == [("dense", 9), ("bricks", 10)]


def test_mesh_cli_writes_stl_and_mesh_ply(tmp_path):
    """``mesh`` on a cloud PLY with normals uses them; the .stl and the .ply
    outputs hold the same mesh, and the normals debug cloud is written."""
    from structured_light_for_3d_model_replication_tpu_torch import cli

    pts, nrm = _sphere(n=3000, seed=7)
    ply.write_ply(str(tmp_path / "c.ply"), pts, np.full(pts.shape, 200, np.uint8), nrm)
    argv = ["--device", "cpu", "--set", "mesh.depth=5"]
    assert cli.main(["mesh", str(tmp_path / "c.ply"), str(tmp_path / "m.stl"),
                     "--save-normals", str(tmp_path / "n.ply")] + argv) == 0
    assert cli.main(["mesh", str(tmp_path / "c.ply"), str(tmp_path / "m.ply")] + argv) == 0
    v_stl, _, _ = jstl.read_stl(str(tmp_path / "m.stl"))
    mesh = jply.read_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(v_stl, mesh["points"][mesh["faces"]].reshape(-1, 3))
    np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "n.ply"))["normals"], nrm)
    r = np.linalg.norm(mesh["points"] - CENTER, axis=1)
    assert len(mesh["faces"]) > 500 and abs(r.mean() - 40.0) < 1.0
