"""The port's scan service (``pipeline/serving.py``) on the CPU, against the
port's solo ``run_pipeline`` and the JAX package's service.

The scene is the 5-view 96x72 scene of ``tests/test_torch_coordinator.py``
(a 64x32 projector, the statistical clean step, the merged cloud's outlier
pass off), served on ``device="cpu"``. Tolerances:

- byte for byte: each served ``merged.ply`` and ``model.stl`` equals the
  port's solo ``run_pipeline`` of the same input, for two tenants over HTTP
  with auth on (their views shared one launch: at least one cross-tenant
  launch; each assembly computed no view), for a third scan planned after
  the store is warm (every view deduped, nothing computed), after an
  injected crash at the assembly boundary and a new service over the same
  root (zero recompute), and after an HA leader's crash and the standby's
  takeover (epoch 2, zero recompute), and when one fleet worker process
  (the only test here that spawns one) computed every view;
- exact: the front door's 401 / 429 answers and reason codes, and /usage
  equal to ``fold_usage`` over the ledger;
- on a card a launch failure fails the group's items (journaled, counted,
  no per-view retry), while an injected fault degrades the group to the
  per-view lane; a stand-in scanner on the ``cuda`` device drives both
  paths here, and the served bytes still equal the solo run's (the
  assembly recomputes the failed views);
- exact: both packages' ``TenantCache`` over one store share one marker
  layout, and evicting a tenant keeps what another tenant references;
  ``doctor`` reports a CPU host's probe verdict (FAIL, exit 1; the probe
  is stubbed here, phase 14(e) of ``chip_smoke.py`` runs it on the card)
  and a held ``.gpu_lock``;
- with the numpy backend, each cleaned view payload (points, colors) the
  port's service cached equals the JAX package's service's byte for byte,
  and the merged clouds are within 1 mm chamfer distance (the rule of
  ``test_torch_pipeline.py``: the merge's RANSAC draws differ).

Every wait is bounded; the HA test's lease is 1 s.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
from structured_light_for_3d_model_replication_tpu.pipeline import serving as jserving
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.pipeline.stagecache import (
    StageCache as JStageCache,
)
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.parallel import admission
from structured_light_for_3d_model_replication_tpu_torch.pipeline import serving
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

VIEWS = 5
STEPS = ("statistical",)
WAIT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("SL3D_FAULTS", raising=False)
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serveds"))
    assert cli_main(["synth", root, "--views", str(VIEWS), "--cam", "96x72",
                     "--proj", "64x32"]) == 0
    return root


def _cfg(cfg=None, backend: str = "torch"):
    cfg = cfg or Config()
    cfg.parallel.backend = backend
    cfg.decode.n_cols, cfg.decode.n_rows = 64, 32
    cfg.decode.thresh_mode = "manual"
    cfg.merge.voxel_size = 4.0
    cfg.merge.ransac_trials = 256
    cfg.merge.icp_iters = 6
    cfg.merge.outlier_nb = 0
    cfg.mesh.depth = 5
    cfg.mesh.density_trim_quantile = 0.0
    cfg.serving.clean_steps = ",".join(STEPS)
    cfg.serving.port = 0
    cfg.parallel.compute_batch = 4
    cfg.pipeline.run_budget_s = 300.0
    return cfg


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def solo(dataset, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_solo"))
    rep = stages.run_pipeline(os.path.join(dataset, "calib.mat"), dataset, out,
                              cfg=_cfg(), steps=STEPS, log=lambda m: None, device="cpu")
    assert rep.failed == [] and not rep.degraded
    return _read(os.path.join(out, "merged.ply")), _read(os.path.join(out, "model.stl"))


def _wait(svc, sid: str) -> dict:
    t0 = time.monotonic()
    d = None
    while time.monotonic() - t0 < WAIT_S:
        d = svc.status(sid)
        if d is not None and d["state"] in admission.TERMINAL:
            return d
        time.sleep(0.05)
    raise TimeoutError(f"{sid} still {d and d['state']} after {WAIT_S}s")


def _assert_solo(svc, sid: str, solo) -> dict:
    d = _wait(svc, sid)
    assert d["state"] == "done", d
    for art, want in (("ply", solo[0]), ("stl", solo[1])):
        path, err = svc.result_path(sid, art)
        assert path, err
        assert _read(path) == want, f"{art} of {sid} differs from the solo run"
    return d


def _post(url: str, payload: dict, key: str | None = None) -> tuple[int, dict]:
    req = urllib.request.Request(url + "/submit", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **({"X-API-Key": key} if key else {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_two_tenants_over_http_equal_the_solo_run(dataset, solo, tmp_path, capsys):
    root = str(tmp_path / "svc")
    keys = {}
    for tenant, extra in (("ta", ["--rate-limit", "1"]), ("tb", [])):
        assert cli_main(["tenant", "add", root, tenant, "--device", "cpu", *extra]) == 0
        keys[tenant] = capsys.readouterr().out.strip().rsplit(" ", 1)[-1]
    cfg = _cfg()
    cfg.serving.auth_enabled = True
    httpd, svc = serving.start_gateway(root, cfg=cfg, log=lambda m: None, device="cpu")
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    calib = os.path.join(dataset, "calib.mat")
    try:
        code, body = _post(url, {"tenant": "ta", "target": dataset, "calib": calib})
        assert (code, body["reason"]) == (401, "auth-required")
        code, body = _post(url, {"tenant": "ta", "target": dataset, "calib": calib},
                           key=keys["tb"])
        assert (code, body["reason"]) == (403, "auth-forbidden")
        sids = {}
        for tenant in ("ta", "tb"):
            code, body = _post(url, {"tenant": tenant, "target": dataset, "calib": calib},
                               key=keys[tenant])
            assert code == 200, body
            sids[tenant] = body["scan_id"]
        code, body = _post(url, {"tenant": "ta", "target": dataset, "calib": calib},
                           key=keys["ta"])
        assert (code, body["reason"]) == (429, "rate-limited") and body["retry_after_s"] > 0
        for sid in sids.values():
            d = _assert_solo(svc, sid, solo)
            assert d["report"]["views_computed"] == 0, d["report"]
            assert _get(f"{url}/result/{sid}?artifact=stl") == solo[1]
        reg = svc.registry
        assert reg.counter_value("sl3d_serve_cross_tenant_launches_total") >= 1
        assert reg.counter_value("sl3d_serve_view_failures_total", tenant="ta") == 0
        # planned after the store is warm: every view deduped, nothing computed
        warmed = sum(reg.counter_value("sl3d_serve_views_warmed_total", tenant=t)
                     for t in ("ta", "tb"))
        dedup = reg.counter_value("sl3d_serve_views_dedup_total", tenant="tb")
        code, body = _post(url, {"tenant": "tb", "target": dataset, "calib": calib,
                                 "scan_id": "again"}, key=keys["tb"])
        assert code == 200, body
        d = _assert_solo(svc, body["scan_id"], solo)
        assert d["report"]["views_computed"] == 0
        assert reg.counter_value("sl3d_serve_views_dedup_total", tenant="tb") == \
            dedup + VIEWS
        assert sum(reg.counter_value("sl3d_serve_views_warmed_total", tenant=t)
                   for t in ("ta", "tb")) == warmed
        usage = json.loads(_get(f"{url}/usage"))
        rs = admission.replay_serving(os.path.join(root, "ledger.jsonl"))
        assert usage == {"schema": "sl3d-usage-v1", "tenants": admission.fold_usage(rs)}
        assert usage["tenants"]["tb"]["done"] == 2
        assert b'tenant="ta"' in _get(f"{url}/metrics")
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def test_a_crash_at_assembly_resumes_with_zero_recompute(dataset, solo, tmp_path):
    root = str(tmp_path / "svc")
    cfg = _cfg()
    cfg.faults.spec = "serve.crash~assembly:crash"
    faults.configure_from(cfg.faults)
    svc = serving.ScanService(root, cfg=cfg, log=lambda m: None, device="cpu")
    svc.start()
    ok, body = svc.submit({"tenant": "ta", "target": dataset, "scan_id": "job1",
                           "calib": os.path.join(dataset, "calib.mat")})
    assert ok, body
    sid = body["scan_id"]
    t0 = time.monotonic()
    while svc.phase != "crashed":
        assert time.monotonic() - t0 < WAIT_S, svc.status(sid)
        time.sleep(0.05)
    assert svc.status(sid)["state"] == "assembling"
    svc.close()
    faults.reset()
    again = serving.ScanService(root, cfg=_cfg(), log=lambda m: None, device="cpu")
    again.start()
    try:
        d = _assert_solo(again, sid, solo)
        assert d["report"]["views_computed"] == 0 and d["report"]["views_cached"] == VIEWS
        assert again.registry.counter_value("sl3d_serve_resumed_total") == 1
    finally:
        again.close()
    rs = admission.replay_serving(os.path.join(root, "ledger.jsonl"))
    assert rs["segments"] == 2 and rs["scans"][sid]["state"] == "done"


def test_an_ha_takeover_recomputes_nothing(dataset, solo, tmp_path):
    root = str(tmp_path / "svc")

    def ha_cfg():
        cfg = _cfg()
        cfg.serving.ha_enabled = True
        cfg.serving.ha_lease_s = 1.0
        cfg.serving.ha_poll_s = 0.1
        return cfg

    cfg = ha_cfg()
    cfg.faults.spec = "serve.crash~assembly:crash"
    faults.configure_from(cfg.faults)
    a = serving.ScanService(root, cfg=cfg, log=lambda m: None, device="cpu")
    a.start()
    b = None
    try:
        t0 = time.monotonic()
        while a.role != "leader":
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.05)
        ok, body = a.submit({"tenant": "ta", "target": dataset,
                             "calib": os.path.join(dataset, "calib.mat")})
        assert ok, body
        sid = body["scan_id"]
        while a.phase != "crashed":
            assert time.monotonic() - t0 < WAIT_S, a.status(sid)
            time.sleep(0.05)
        faults.reset()
        assert a.election.current()["owner"] == a.run_id   # never released
        b = serving.ScanService(root, cfg=ha_cfg(), log=lambda m: None, device="cpu")
        b.start()
        ok, body = b.submit({"tenant": "ta", "target": dataset,
                             "calib": os.path.join(dataset, "calib.mat")})
        assert not ok and body["reason"] == "not-leader"
        while b.role != "leader":
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.05)
        assert b.epoch == 2
        d = _assert_solo(b, sid, solo)
        assert d["report"]["views_computed"] == 0 and d["report"]["views_cached"] == VIEWS
        assert b.registry.counter_value("sl3d_serve_views_warmed_total", tenant="ta") == 0
        rs = admission.replay_serving(os.path.join(root, "ledger.jsonl"))
        assert rs["max_epoch"] == 2 and rs["scans"][sid]["state"] == "done"
    finally:
        if b is not None:
            b.close()
        a.close()


def test_a_fleet_worker_warms_the_store_and_the_bytes_equal_solo(dataset, solo, tmp_path,
                                                                 monkeypatch):
    """The one test that spawns fleet workers: one port worker on the CPU,
    the engine lane held off the grant pool so the worker computes every
    view; the ledger holds the spawn, the worker's log ends with its exit
    line, and no worker process outlives ``close``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    calib = os.path.join(dataset, "calib.mat")
    cfg = _cfg()
    cfg.serving.fleet_enabled = True
    cfg.serving.fleet_min_workers = cfg.serving.fleet_max_workers = 1
    cfg.serving.fleet_poll_s = 0.1
    root = str(tmp_path / "svc")
    svc = serving.ScanService(root, cfg=cfg, log=lambda m: None, device="cpu")
    next_views = svc.adm.next_views
    svc.adm.next_views = lambda lane, n: [] if lane.startswith("lane") \
        else next_views(lane, n)
    svc.start()
    procs = []
    try:
        t0 = time.monotonic()
        while not svc.fleet.state()["hellos"]:
            assert time.monotonic() - t0 < WAIT_S, "the fleet worker never said hello"
            time.sleep(0.1)
        procs = [w["proc"] for w in svc.fleet._workers.values()]
        ok, body = svc.submit({"tenant": "ta", "target": dataset, "calib": calib})
        assert ok, body
        d = _assert_solo(svc, body["scan_id"], solo)
        assert d["report"]["views_computed"] == 0, d
    finally:
        svc.close()
    assert procs and all(p.poll() is not None for p in procs)
    with open(os.path.join(root, "ledger.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert any(e["type"] == "fleet" and e["action"] == "spawn" for e in events)
    done = [e for e in events if e["type"] == "complete"]
    assert len(done) == VIEWS and {e["worker"] for e in done} == {"fw0"}
    with open(os.path.join(root, "fleet", "worker0.log")) as f:
        log = f.read()
    assert "device cpu" in log and "exit: launches" in log
    with open(os.path.join(root, "fleet", "worker0.json")) as f:
        spec = json.load(f)
    assert spec["device"] == "cpu" and spec["worker"] == "fw0"
    assert spec["cache_root"] == os.path.join(root, "cache")


class _CardScanner:
    """A stand-in for a scanner on the card: its device says ``cuda``, it
    raises ``error`` on a launch of several views and runs the real CPU
    scanner on one view."""

    def __init__(self, real, error: BaseException):
        self.real, self.error = real, error
        self.device = torch.device("cuda")
        self.launches = []

    def forward_views(self, frames_v, **kw):
        self.launches.append(len(frames_v))
        if len(frames_v) > 1:
            raise self.error
        return self.real.forward_views(frames_v, **kw)


@pytest.mark.parametrize("injected", [False, True], ids=["kernel-error", "injected"])
def test_a_failed_launch_on_the_card_fails_its_items(dataset, solo, tmp_path, injected):
    logs = []
    svc = serving.ScanService(str(tmp_path / "svc"), cfg=_cfg(), log=logs.append,
                              device="cpu")
    error = (faults.TransientFault("injected launch fault") if injected
             else RuntimeError("slscan_decode_maps: CUDA error 700 (illegal address)"))
    scanner_for = svc._scanner_for
    fakes = []

    def fake_for(ctx):
        if not fakes:
            fakes.append(_CardScanner(scanner_for(ctx), error))
        return fakes[0]

    svc._scanner_for = fake_for
    svc.start()
    try:
        ok, body = svc.submit({"tenant": "ta", "target": dataset,
                               "calib": os.path.join(dataset, "calib.mat")})
        assert ok, body
        d = _assert_solo(svc, body["scan_id"], solo)
        failures = svc.registry.counter_value("sl3d_serve_view_failures_total", tenant="ta")
        degraded = [m for m in logs if "degraded to per-view" in m]
        launch_fail = [m for m in logs if "view FAILED (launch: RuntimeError" in m]
        if injected:
            # the group re-ran one view at a time, then the fifth view alone
            assert fakes[0].launches == [4, 1, 1, 1, 1, 1]
            assert degraded and not launch_fail and failures == 0
            assert d["report"]["views_computed"] == 0
        else:
            # no per-view retry of the failed group: the assembly recomputed it
            assert fakes[0].launches == [4, 1]
            assert not degraded and failures == len(launch_fail) == 4
            assert d["report"]["views_computed"] == 4
    finally:
        svc.close()


def _views(store: str, keys, cache_cls) -> list:
    cache = cache_cls(store, log=lambda m: None)
    out = []
    for k in keys:
        hit = cache.get("view", k)
        assert hit is not None
        out.append((np.asarray(hit["points"], np.float32), np.asarray(hit["colors"], np.uint8)))
    return out


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def test_numpy_backend_views_equal_the_jax_service(dataset, tmp_path):
    calib = os.path.join(dataset, "calib.mat")
    payload = {"tenant": "ta", "target": dataset, "calib": calib, "scan_id": "np"}
    merged = {}
    for name, mod, cfg in (("port", serving, _cfg(backend="numpy")),
                           ("jax", jserving, _cfg(JConfig(), backend="numpy"))):
        kw = {"device": "cpu"} if name == "port" else {}
        svc = mod.ScanService(str(tmp_path / name), cfg=cfg, log=lambda m: None, **kw)
        svc.start()
        try:
            ok, body = svc.submit(payload)
            assert ok, body
            d = _wait(svc, body["scan_id"])
            assert d["state"] == "done", d
            merged[name] = ply.read_ply(svc.result_path(body["scan_id"], "ply")[0])["points"]
        finally:
            svc.close()
    pcfg, jcfg = _cfg(backend="numpy"), _cfg(JConfig(), backend="numpy")
    pstore, jstore = str(tmp_path / "port" / "cache"), str(tmp_path / "jax" / "cache")
    _, _, keys, _ = stages._view_plan(calib, dataset, pcfg, STEPS, StageCache(pstore),
                                      lambda m: None, torch.device("cpu"))
    _, _, _, jkeys = jstages._view_plan(calib, dataset, jcfg, STEPS, JStageCache(jstore),
                                        lambda m: None)
    for i, (a, b) in enumerate(zip(_views(pstore, keys, StageCache),
                                   _views(jstore, jkeys, JStageCache))):
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes(), i
    assert _chamfer(merged["port"], merged["jax"]) < 1.0


def test_the_service_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.ScanService(str(tmp_path / "svc"), cfg=_cfg(), log=lambda m: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["serve", str(tmp_path / "svc2"), "--port", "0"])
    assert cli_main(["warmup", "--device", "cpu", "--cache-dir", "x"]) == 0


def test_tenant_namespaces_share_one_store_with_the_jax_package(tmp_path):
    """Both packages' ``TenantCache`` over one store: the same marker
    layout, and evicting a tenant keeps every payload another tenant (of
    either package) still references."""
    from structured_light_for_3d_model_replication_tpu.pipeline.stagecache import (
        TenantCache as JTenantCache,
    )
    from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
        TenantCache,
    )

    store = str(tmp_path / "cache")
    mine = TenantCache(store, "alice/../x", log=lambda m: None)
    theirs = JTenantCache(store, "bob", log=lambda m: None)
    shared, own = "ab" * 32, "cd" * 32
    mine.put("view", shared, points=np.zeros((3, 3), np.float32))
    mine.put("view", own, points=np.ones((2, 3), np.float32))
    assert theirs.get("view", shared) is not None            # dedup across tenants
    assert mine.ns_dir.endswith(os.path.join("cache-ns", "alice_.._x"))
    assert sorted(os.listdir(mine.ns_dir)) == [f"view-{shared[:16]}.ref",
                                               f"view-{own[:16]}.ref"]
    assert theirs.refs() == [f"view-{shared[:16]}"]
    assert TenantCache.tenants(mine.ns_root) == JTenantCache.tenants(mine.ns_root)
    out = TenantCache.evict_tenant(store, "alice/../x")
    assert out == {"refs_dropped": 2, "payloads_deleted": 1, "payloads_kept": 1}
    assert theirs.get("view", shared) is not None and mine.get("view", own) is None
    assert JTenantCache.evict_tenant(store, "bob")["payloads_deleted"] == 1
    with pytest.raises(ValueError):
        TenantCache(store, "...")


def test_doctor_reports_the_probe_and_the_card_lock(tmp_path, capsys, monkeypatch):
    """The probe's verdict on a host without CUDA (the subprocess probe
    itself runs on the card in ``chip_smoke.py`` phase 14(e))."""
    from structured_light_for_3d_model_replication_tpu_torch.utils import gpulock
    from structured_light_for_3d_model_replication_tpu_torch.utils import preflight

    monkeypatch.setattr(preflight, "accelerator_preflight",
                        lambda timeout, cwd=None: ("ok", "cpu"))
    held = gpulock.acquire_gpu_lock(str(tmp_path))
    try:
        assert cli_main(["doctor", "--root", str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "[doctor] card: FAIL — ok (cpu)" in out and "gpu lock: HELD (pid " in out
        assert "ISSUES FOUND" in out
    finally:
        held.close()
    assert cli_main(["doctor", "--no-probe", "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "gpu lock: free" in out and "kernel library: " in out
    assert gpulock.probe_gpu_lock(str(tmp_path)) == (False, "free")
