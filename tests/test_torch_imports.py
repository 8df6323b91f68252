"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A subprocess imports every port module (this process already imported jax
through tests/conftest.py) and checks that ``jax`` never loaded; an AST scan
checks every port file and ``chip_smoke.py`` for imports of ``jax`` or of
the JAX package. Also: the CUDA sources are in the tree, and a build
without a working nvcc raises instead of falling back; the native IO
runtime's source is the port's own copy, and the port never loads the JAX
package's ``native/libslio.so``.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "structured_light_for_3d_model_replication_tpu_torch"
JAX_PKG = "structured_light_for_3d_model_replication_tpu"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted((ROOT / PKG).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_leaves_jax_unloaded():
    mods = _port_modules()
    assert len(mods) >= 15
    for m in ("utils.telemetry", "utils.faults", "utils.deadline", "utils.profiling",
              "pipeline.stagecache", "ops.fused_view", "io.native", "pipeline.report",
              "acquire.viewer", "ops.posegraph", "ops.surface_recon",
              "calib.chessboard", "calib.inspect", "calib.undistort", "calib.pipeline",
              "calib.visualize", "acquire.projector", "acquire.turntable",
              "acquire.server", "acquire.sequencer", "acquire.autoscan", "acquire.webcam",
              "acquire.android", "parallel", "parallel.netutil", "parallel.lease",
              "parallel.coordinator", "parallel.worker", "pipeline.blobstore",
              "pipeline.assembly", "parallel.admission", "parallel.election",
              "parallel.fleet", "pipeline.serving", "utils.preflight", "utils.gpulock"):
        assert f"{PKG}.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            f" or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


@pytest.mark.parametrize("target", [PKG, "chip_smoke.py"])
def test_no_source_imports_jax_or_the_jax_package(target):
    base = ROOT / target
    files = sorted(base.rglob("*.py")) if base.is_dir() else [base]
    assert files
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", JAX_PKG), f"{path}: imports {name}"


def test_cuda_sources_carry_their_notes():
    src = (ROOT / PKG / "ops" / "csrc" / "decode.cu").read_text()
    for pallas in ("_decode_kernel", "_decode_packed_kernel", "_scan_fused_kernel"):
        assert pallas in src
    for entry in ("slscan_decode_maps", "slscan_decode_packed_maps",
                  "slscan_scan_fused"):
        assert f"int {entry}(" in src
    assert "bandwidth" in src and "cudaGetLastError()" in src


def test_merge_kernel_source_carries_its_notes_and_builds_into_the_library():
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build, kernels

    src = (ROOT / PKG / "ops" / "csrc" / "cloud.cu").read_text()
    for pallas in ("_nn1_kernel", "_ransac_score_kernel", "_knn_mean_kernel",
                   "_slab_bisect_kernel", "_radius_kernel"):
        assert pallas in src
    for entry in ("slscan_nn1", "slscan_ransac_score", "slscan_knn_mean",
                  "slscan_slab_mean_knn", "slscan_radius_count"):
        assert f"int {entry}(" in src and entry in kernels._SIGNATURES
    assert "operations" in src and "cudaGetLastError()" in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    # one library: both sources, compiled side by side, both in the content hash
    assert [os.path.basename(s) for s in _build.sources()] == ["cloud.cu", "decode.cu"]
    assert {k.__name__ for k in kernels.KERNELS} >= {
        "nn1", "ransac_score", "knn_mean", "slab_mean_knn", "radius_count"}


def test_failed_or_impossible_build_raises(tmp_path, monkeypatch):
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library_path",
                        lambda: str(tmp_path / "k" / "libslscan_kernels.so"))
    # a compiler that fails: the build raises with its exit code
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list((tmp_path / "k").glob("*.so"))
    # no compiler at all
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_the_native_io_source_is_the_ports_own():
    src = (ROOT / PKG / "io" / "csrc" / "slio.cpp").read_text()
    for entry in ("slio_probe_png", "slio_load_gray_stack", "slio_write_ply",
                  "slio_write_stl", "slio_abi_version"):
        assert f"int {entry}(" in src
    assert "int slio_abi_version() { return 1; }" in src
    binding = (ROOT / PKG / "io" / "native.py").read_text()
    assert 'os.path.join(_HERE, "csrc", "slio.cpp")' in binding
    assert "SLIO_LIBRARY" not in binding and "parents" not in binding


def test_the_coordinator_spawns_the_ports_worker(tmp_path, monkeypatch):
    """``_spawn_worker`` starts ``python -m <port> worker --spec`` (never the
    JAX package's CLI) with the coordinator's device in the spec and the
    coordinator's ``sys.path`` on the child's PYTHONPATH."""
    from structured_light_for_3d_model_replication_tpu_torch.parallel import coordinator

    seen = {}

    class _Popen:
        def __init__(self, argv, stdout=None, stderr=None, env=None):
            seen["argv"], seen["env"] = argv, env

    monkeypatch.setattr(coordinator.subprocess, "Popen", _Popen)
    coordinator._spawn_worker(3, 4, 5555, str(tmp_path), "cfg.json", "calib.mat", "scans",
                              str(tmp_path), ("statistical",), "cuda")
    spec_path = str(tmp_path / "worker3.json")
    assert seen["argv"] == [sys.executable, "-m", PKG, "worker", "--spec", spec_path]
    assert str(ROOT) in seen["env"]["PYTHONPATH"].split(os.pathsep)
    import json

    spec = json.loads(pathlib.Path(spec_path).read_text())
    assert (spec["worker"], spec["device"], spec["port"]) == ("w3", "cuda", 5555)
    assert "cache_root" not in spec
