"""The port's native IO runtime (``io/native.py`` + ``io/csrc/slio.cpp``)
against the JAX package's ``io/native.py`` and the Python readers/writers.

The port's library is built with g++ into a temporary directory; the JAX
package's ``native/slio.cpp`` is built there too, with the same flags, and
its ``io/native`` is pointed at it (``SLIO_LIBRARY``). Exactly, byte for
byte, under the same flags:

- gray PNG stacks (noise, gradients, odd sizes): the port's native decode
  equals the JAX package's native decode and cv2's gray read;
- color PNG stacks: the port's native decode equals the JAX package's (the
  BT.601 fixed-point gray; it may differ from cv2's by one level, so cv2 is
  not the reference there);
- clouds of 100,000 points or more and meshes of 50,000 faces or more go
  through the native writers in ``ply.write_ply`` / ``stl.write_stl``, and
  their files equal the JAX package's native writers' files. Against the
  port's numpy writers: the PLY records are the same bytes and the header
  differs by the ``comment slio native writer`` line alone; the STL
  vertex and attribute bytes are equal and the float32 face normals
  within 1e-4 of the numpy writer's float64-normalized ones (the 80-byte
  header differs), as in the JAX package;
- the JAX package's source built with its Makefile's flags (``-march=native``
  and GCC's default contraction) writes the same gray stacks, PLY bytes and
  STL headers, vertices and attributes; only STL face normals differ: by
  at most 1e-5 on faces of nonzero area, and on zero-area faces, where an
  FMA residue may give a unit normal in place of zeros;
- ``load_stack`` takes the native decoder first;
- a host without g++ or without libpng, or an install without the source,
  reports ``available() is False`` (one stderr line names what is missing)
  and the Python paths run: the cv2 stack read, the numpy PLY and STL
  writers at and above the native thresholds;
- a source that does not compile, or a library with another ABI version,
  raises.
"""
import os
import re
import shutil
import subprocess

import cv2
import numpy as np
import pytest

from structured_light_for_3d_model_replication_tpu.io import images as jimio
from structured_light_for_3d_model_replication_tpu.io import native as jnative
from structured_light_for_3d_model_replication_tpu.io import ply as jply
from structured_light_for_3d_model_replication_tpu.io import stl as jstl
from structured_light_for_3d_model_replication_tpu_torch.io import images as imio
from structured_light_for_3d_model_replication_tpu_torch.io import native
from structured_light_for_3d_model_replication_tpu_torch.io import ply, stl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(port library path, JAX-side library path), both built here."""
    d = tmp_path_factory.mktemp("slio")
    path, missing = native.build(root=str(d / "port"))
    assert missing is None and os.path.isfile(path)
    jpath = str(d / "libslio_jax.so")
    subprocess.run(["g++", *native.CXX_FLAGS, "-o", jpath,
                    os.path.join(ROOT, "native", "slio.cpp"), *native.LIBS], check=True)
    return path, jpath


@pytest.fixture
def libs(built, monkeypatch):
    """The port's binding on its built library, the JAX package's on its."""
    path, jpath = built
    monkeypatch.setattr(native, "_state", {"lib": native.load(path), "path": path,
                                           "missing": None})
    monkeypatch.setenv("SLIO_LIBRARY", jpath)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert native.available() and jnative.available()
    return path, jpath


def _frames(rng, n, h, w, color=False):
    shape = (n, h, w, 3) if color else (n, h, w)
    base = (np.indices(shape[1:]).sum(0) * 7) % 256
    return np.clip(base + rng.integers(-40, 41, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_gray_stacks_equal_the_jax_library_and_cv2(libs, tmp_path, h, w):
    frames = _frames(np.random.default_rng(h), 6, h, w)
    paths = jimio.save_stack(str(tmp_path / "v"), frames)
    assert native.probe_png(paths[0]) == jnative.probe_png(paths[0]) == (w, h, 1)
    got = native.load_gray_stack(paths, w, h)
    np.testing.assert_array_equal(got, jnative.load_gray_stack(paths, w, h))
    np.testing.assert_array_equal(got, np.stack([cv2.imread(p, 0) for p in paths]))
    np.testing.assert_array_equal(got, frames)
    assert native.load_gray_stack(paths, w + 1, h) is None        # a size mismatch
    assert native.load_gray_stack(paths[:1] + ["x.bmp"], w, h) is None


def test_color_stacks_equal_the_jax_library(libs, tmp_path):
    frames = _frames(np.random.default_rng(7), 4, 40, 56, color=True)
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"{i + 1:02d}.png"), f)
    paths = sorted(str(p) for p in tmp_path.glob("*.png"))
    got = native.load_gray_stack(paths, 56, 40)
    np.testing.assert_array_equal(got, jnative.load_gray_stack(paths, 56, 40))
    cv = np.stack([cv2.imread(p, 0) for p in paths]).astype(np.int16)
    assert np.abs(got.astype(np.int16) - cv).max() <= 1


def _cloud(n):
    rng = np.random.default_rng(n)
    return (rng.normal(0, 80, (n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8),
            rng.normal(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("fields", ["xyz", "rgb", "rgb+normals"])
def test_native_ply_equals_the_jax_writer_and_the_numpy_records(libs, tmp_path, fields):
    pts, cols, nrm = _cloud(100_000)
    kw = {"rgb": {"colors": cols}, "rgb+normals": {"colors": cols, "normals": nrm},
          "xyz": {}}[fields]
    ply.write_ply(str(tmp_path / "p.ply"), pts, **kw)
    jply.write_ply(str(tmp_path / "j.ply"), pts, **kw)
    got = (tmp_path / "p.ply").read_bytes()
    assert got == (tmp_path / "j.ply").read_bytes()
    assert b"comment slio native writer\n" in got[:200]
    # the numpy writer below the threshold writes the same records
    ply.write_ply(str(tmp_path / "n.ply"), pts[:99_999], **{k: v[:99_999] for k, v in kw.items()})
    ref = (tmp_path / "n.ply").read_bytes()
    head, body = got.split(b"end_header\n", 1)
    rhead, rbody = ref.split(b"end_header\n", 1)
    assert body[:len(rbody)] == rbody and len(body) == len(rbody) * 100_000 // 99_999
    assert head.replace(b"comment slio native writer\n", b"").replace(
        b"100000", b"99999") == rhead
    back = ply.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_array_equal(back["points"], pts)
    assert not os.path.exists(str(tmp_path / "p.ply.tmp"))


def test_native_stl_equals_the_jax_writer(libs, tmp_path):
    rng = np.random.default_rng(11)
    verts = rng.normal(0, 10, (20_000, 3)).astype(np.float32)
    faces = rng.integers(0, 20_000, (50_000, 3)).astype(np.int32)
    stl.write_stl(str(tmp_path / "p.stl"), verts, faces)
    jstl.write_stl(str(tmp_path / "j.stl"), verts, faces)
    got = (tmp_path / "p.stl").read_bytes()
    assert got == (tmp_path / "j.stl").read_bytes() and got.startswith(b"slio native stl")
    stl.write_stl(str(tmp_path / "n.stl"), verts, faces, normals=stl.face_normals(verts, faces))
    rec = np.dtype([("normal", "<f4", 3), ("v", "<f4", 9), ("attr", "<u2")])
    a = np.frombuffer(got[84:], rec)
    b = np.frombuffer((tmp_path / "n.stl").read_bytes()[84:], rec)
    assert got[80:84] == (tmp_path / "n.stl").read_bytes()[80:84]
    assert a["v"].tobytes() == b["v"].tobytes() and a["attr"].tobytes() == b["attr"].tobytes()
    assert np.abs(a["normal"] - b["normal"]).max() < 1e-4
    # below the threshold, or with normals given, the numpy writer runs
    stl.write_stl(str(tmp_path / "s.stl"), verts, faces[:49_999])
    jstl.write_stl(str(tmp_path / "js.stl"), verts, faces[:49_999])
    assert (tmp_path / "s.stl").read_bytes() == (tmp_path / "js.stl").read_bytes()
    assert (tmp_path / "s.stl").read_bytes()[:4] == b"stru"


def test_load_stack_takes_the_native_decoder_first(libs, tmp_path, monkeypatch):
    frames = _frames(np.random.default_rng(3), 6, 30, 40)
    jimio.save_stack(str(tmp_path / "v"), frames)
    calls = []
    real = native.load_gray_stack

    def spy(paths, w, h, n_threads=0):
        calls.append(n_threads)
        return real(paths, w, h, n_threads)

    monkeypatch.setattr(native, "load_gray_stack", spy)
    monkeypatch.setattr(imio, "load_gray", lambda p: pytest.fail("cv2 path taken"))
    got, texture = imio.load_stack(str(tmp_path / "v"), io_workers=3)
    assert calls == [0]     # the JAX package's thread count: one a hardware thread
    np.testing.assert_array_equal(got, frames)
    jgot, jtex = jimio.load_stack(str(tmp_path / "v"))
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(texture, jtex)


def test_the_makefile_build_differs_only_in_stl_normals(libs, tmp_path, monkeypatch):
    """The JAX package's library as its Makefile builds it, against the
    port's: PNG decode and the PLY writer do no float arithmetic, so they
    match on any host; the STL normals may be contracted into FMAs."""
    make = open(os.path.join(ROOT, "native", "Makefile")).read()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    jpath = str(tmp_path / "libslio_make.so")
    subprocess.run(["g++", *flags, "-shared", "-o", jpath,
                    os.path.join(ROOT, "native", "slio.cpp"), *native.LIBS], check=True)
    frames = _frames(np.random.default_rng(9), 4, 33, 47)
    paths = jimio.save_stack(str(tmp_path / "v"), frames)
    pts, cols, nrm = _cloud(1000)
    rng = np.random.default_rng(11)
    verts = rng.normal(0, 10, (2000, 3)).astype(np.float32)
    faces = rng.integers(0, 2000, (5000, 3)).astype(np.int32)
    faces[:50, 2] = faces[:50, 1]                         # zero-area faces
    native.write_ply_native(str(tmp_path / "p.ply"), pts, cols, nrm)
    native.write_stl_native(str(tmp_path / "p.stl"), verts, faces)
    monkeypatch.setenv("SLIO_LIBRARY", jpath)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    np.testing.assert_array_equal(jnative.load_gray_stack(paths, 47, 33),
                                  native.load_gray_stack(paths, 47, 33))
    jnative.write_ply_native(str(tmp_path / "j.ply"), pts, cols, nrm)
    jnative.write_stl_native(str(tmp_path / "j.stl"), verts, faces)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got, want = (tmp_path / "p.stl").read_bytes(), (tmp_path / "j.stl").read_bytes()
    assert got[:84] == want[:84]
    rec = np.dtype([("normal", "<f4", 3), ("v", "<f4", 9), ("attr", "<u2")])
    a, b = np.frombuffer(got[84:], rec), np.frombuffer(want[84:], rec)
    assert a["v"].tobytes() == b["v"].tobytes() and a["attr"].tobytes() == b["attr"].tobytes()
    tri = verts[faces].astype(np.float64)
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    assert np.abs(a["normal"] - b["normal"])[area > 0].max() <= 1e-5
    assert not a["normal"][area == 0].any()


@pytest.mark.parametrize("what", ["g++", "libpng", "source"])
def test_a_host_without_the_toolchain_falls_back(tmp_path, monkeypatch, capsys, what):
    if what == "g++":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    elif what == "source":          # an install that left out io/csrc/slio.cpp
        monkeypatch.setattr(native, "SOURCE", str(tmp_path / "csrc" / "slio.cpp"))
    else:
        monkeypatch.setattr(native, "_PROBE", "#include <no_such_png_header.h>\n"
                                              "int main() { return 0; }\n")
    monkeypatch.setattr(native, "library_path",
                        lambda root=None: str(tmp_path / "b" / "libslio.so"))
    monkeypatch.setattr(native, "_state", {})
    assert native.available() is False
    path, missing = native.status()
    assert path is None and (what in missing)
    err = capsys.readouterr().err
    assert err.count("[native] unavailable:") == 1 and what in err
    assert native.probe_png("x.png") is None and not native.write_ply_native("x", np.zeros((1, 3)))
    # the Python paths run: the numpy PLY writer, the cv2 stack read
    pts, cols, _ = _cloud(100_000)
    ply.write_ply(str(tmp_path / "p.ply"), pts, cols)
    assert b"slio" not in (tmp_path / "p.ply").read_bytes()[:200]
    assert ply.read_ply(str(tmp_path / "p.ply"))["points"].tobytes() == pts.tobytes()
    rng = np.random.default_rng(2)
    verts = rng.normal(0, 10, (1000, 3)).astype(np.float32)
    faces = rng.integers(0, 1000, (50_000, 3)).astype(np.int32)
    stl.write_stl(str(tmp_path / "m.stl"), verts, faces)
    assert (tmp_path / "m.stl").read_bytes()[:4] == b"stru"
    assert len((tmp_path / "m.stl").read_bytes()) == 84 + 50 * 50_000
    frames = _frames(np.random.default_rng(5), 4, 20, 24)
    jimio.save_stack(str(tmp_path / "v"), frames)
    np.testing.assert_array_equal(imio.load_stack(str(tmp_path / "v"))[0], frames)


def test_a_broken_source_or_abi_raises(tmp_path, monkeypatch):
    assert shutil.which("g++") is not None, "g++ is needed to build the native library"
    bad = tmp_path / "slio.cpp"
    bad.write_text("this is not C++ {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(root=str(tmp_path / "b"))
    abi = tmp_path / "abi.cpp"
    abi.write_text('extern "C" int slio_abi_version() { return 2; }\n')
    lib = str(tmp_path / "libabi.so")
    subprocess.run(["g++", "-shared", "-fPIC", "-o", lib, str(abi)], check=True)
    with pytest.raises(RuntimeError, match="expected 1"):
        native.load(lib)


def test_a_library_that_does_not_load_is_built_anew(tmp_path, monkeypatch):
    """A library at the build path that does not load (one built on another
    host, in a copied tree) is replaced by a build on this host."""
    path = tmp_path / "b" / "libslio.so"
    path.parent.mkdir()
    path.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "library_path", lambda root=None: str(path))
    monkeypatch.setattr(native, "_state", {})
    assert native.available() and native.status() == (str(path), None)
    assert path.read_bytes()[:4] == b"\x7fELF"
