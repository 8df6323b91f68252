"""The port's admission control and front door (``parallel/admission.py``)
against the JAX package's, with fake items and an injected clock.

Exact, with no tolerance:

- one script of submits (quota, queue-depth and breaker rejections
  included), weighted-fair admissions and grants, completes, failures, a
  dropped lane, sheds, checkpoints, resumes and breaker trips gives the same
  return values, grant order, signals, snapshot and ledger events in both
  packages; event timestamps (``t``, ``t0_unix``) and the real-clock waits
  (``wait_s``, ``elapsed_s``, the wait a shed reason quotes) are left out
  of the comparison, the run ids differ by construction;
- ``replay_serving`` and ``fold_usage`` of a ledger written by either
  package fold to the same result in the other, a torn tail and a stale
  epoch included;
- a ``tenants.json`` written by either package's ``write_tenant`` or
  ``tenant add`` command authenticates in the other, and the 401 / 403 /
  429 matrix (``TenantAuth.check``, ``RateLimiter.allow`` under an injected
  clock, the gateway's reason-to-status table) gives the same reason codes.
"""
import json
import os
import re

import pytest

from structured_light_for_3d_model_replication_tpu import cli as jcli
from structured_light_for_3d_model_replication_tpu.parallel import admission as jadm
from structured_light_for_3d_model_replication_tpu.pipeline import serving as jserving
from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
from structured_light_for_3d_model_replication_tpu_torch.parallel import admission
from structured_light_for_3d_model_replication_tpu_torch.parallel.coordinator import Ledger
from structured_light_for_3d_model_replication_tpu_torch.pipeline import serving

PKGS = {"jax": jadm, "port": admission}
_VOLATILE = ("t", "t0_unix", "run_id", "wait_s", "elapsed_s")


class FakeClock:
    def __init__(self):
        self.t = 500.0

    def __call__(self) -> float:
        return self.t


def _events(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            rec = {k: v for k, v in json.loads(line).items() if k not in _VOLATILE}
            if rec["type"] == "shed":   # the reason quotes the real-clock wait
                rec["reason"] = re.sub(r"wait [0-9.]+s", "wait Ns", rec["reason"])
            out.append(rec)
    return out


def _script(mod, ledger: str) -> list:
    """The admission script; returns its trace of return values."""
    clk = FakeClock()
    adm = mod.AdmissionController(
        ledger, "run", lease_s=30.0, max_active_scans=2, tenant_active_quota=1,
        tenant_queue_quota=2, queue_depth=5, max_queue_wait_s=50.0,
        breaker_threshold=2, breaker_cooldown_s=10.0, clock=clk, log=lambda m: None)
    out = []

    def job(sid, tenant, weight=1.0, budget=0.0):
        return mod.ScanJob(sid, tenant, f"/data/{sid}", "/data/calib.mat",
                           f"/out/{sid}", weight=weight, budget_s=budget)

    def items(sid, n):
        return adm.add_items(sid, [{"index": i, "src": f"/data/{sid}/v{i}",
                                    "key": f"{sid}-k{i}", "scan": sid}
                                   for i in range(n)])

    def strip(rv):
        ok, info = rv
        return ok, {k: v for k, v in info.items() if k != "error"}

    for sid, tenant, w in (("a1", "ta", 1.0), ("a2", "ta", 1.0), ("a3", "ta", 1.0),
                           ("b1", "tb", 2.0), ("c1", "tc", 1.0), ("b2", "tb", 2.0),
                           ("d1", "td", 1.0)):
        out.append(("submit", sid, strip(adm.submit(job(sid, tenant, w)))))
    out.append(("admit", [j.scan_id for j in adm.admit_next()]))
    out.append(("items", items("a1", 3), items("b1", 4)))
    grants = adm.next_views("lane0", 5)
    out.append(("grants", [(g[0], g[1]) for g in grants]))
    out.append(("signals", {k: v for k, v in adm.signals().items()
                            if not k.startswith("queue_wait")}))
    for iid, gen, _ in grants[:3]:
        out.append(("complete", iid, adm.complete(iid, "lane0", gen)))
    adm.failed(grants[3][0], "lane0", grants[3][1], "compute: boom")
    out.append(("late", adm.complete(grants[4][0], "lane9", grants[4][1])))
    out.append(("dropped", adm.drop_lane("lane0", "worker-dead")))
    more = adm.next_views("fw0", 8)
    out.append(("regrants", [(g[0], g[1]) for g in more]))
    for iid, gen, _ in more:
        adm.complete(iid, "fw0", gen)
    out.append(("settled", adm.scan_settled("a1"), adm.scan_settled("b1"),
                adm.scan_item_states("b1")))
    adm.finish("a1", "failed", error="assembly: x")
    adm.finish("b1", "done", report={"views_computed": 0})
    adm.jobs["c1"].submitted_mono -= 100.0          # c1 waited past the cap
    out.append(("shed", [j.scan_id for j in adm.shed_expired()]))
    out.append(("admit2", [j.scan_id for j in adm.admit_next()]))
    for sid in [s for s, j in adm.jobs.items() if j.state == "admitted"]:
        items(sid, 1)
        adm.finish(sid, "failed" if adm.jobs[sid].tenant == "ta" else "done")
    out.append(("admit3", [j.scan_id for j in adm.admit_next()]))
    for sid in [s for s, j in adm.jobs.items() if j.state == "admitted"]:
        adm.finish(sid, "aborted" if adm.jobs[sid].tenant == "ta" else "done")
    out.append(("open", adm.open_breakers()))
    out.append(("rejected open", strip(adm.submit(job("a4", "ta")))))
    clk.t += 11.0
    out.append(("probe", strip(adm.submit(job("a5", "ta")))))
    out.append(("second probe", strip(adm.submit(job("a6", "ta")))))
    out.append(("admit4", [j.scan_id for j in adm.admit_next()]))
    adm.finish("a5", "done")
    out.append(("closed", adm.open_breakers()))
    out.append(("submit e1", strip(adm.submit(job("e1", "te")))))
    out.append(("checkpoint", adm.checkpoint("e1", "drain budget 0s exceeded"),
                adm.checkpoint("a5")))
    adm.restore(job("e1", "te"))
    adm.restore_breaker("tf", 3)
    out.append(("restored", adm.open_breakers()))
    snap = adm.snapshot()
    out.append(("snapshot", snap["states"], snap["queued"], snap["active"],
                snap["vtime"], sorted(snap["scans"])))
    adm.close()
    return out


def test_one_script_gives_the_jax_grants_and_ledger(tmp_path):
    traces, ledgers = {}, {}
    for name, mod in PKGS.items():
        path = str(tmp_path / f"{name}.jsonl")
        traces[name] = _script(mod, path)
        ledgers[name] = _events(path)
    assert traces["port"] == traces["jax"]
    assert ledgers["port"] == ledgers["jax"]
    kinds = {e["type"] for e in ledgers["port"]}
    assert {"submit", "admit", "plan", "grant", "complete", "late-complete", "failed",
            "steal", "finish", "shed", "breaker-open", "breaker-probe", "breaker-close",
            "checkpoint", "resume"} <= kinds


def _ledger_with_epochs(path: str) -> None:
    """A serving ledger from the port's Ledger: an epoch-1 segment, an
    epoch-2 segment, a stale epoch-1 line past it, and a torn tail."""
    epoch = [1]
    led = Ledger(path, "r1", meta={"mode": "serving"}, epoch=lambda: epoch[0])
    for sid, tenant in (("s1", "ta"), ("s2", "tb"), ("s3", "ta")):
        led.event("submit", scan=sid, tenant=tenant, target=f"/d/{sid}", calib="/c",
                  out_dir=f"/o/{sid}", weight=1.0, budget_s=0.0)
    led.event("admit", scan="s1", tenant="ta", wait_s=0.1)
    led.event("complete", item="s1/view:0", scan="s1", tenant="ta", worker="lane0", gen=1)
    led.event("complete", item="s2/view:0", scan="s2", tenant="tb", worker="lane0", gen=1)
    led.event("finish", scan="s2", tenant="tb", state="failed", error="x", elapsed_s=2.5,
              report={})
    led.close()
    epoch[0] = 2
    led = Ledger(path, "r2", meta={"mode": "serving"}, epoch=lambda: epoch[0])
    led.event("takeover", owner="r2")
    led.event("resume", scan="s1", tenant="ta")
    led.event("warmed", scan="s1")
    led.event("finish", scan="s1", tenant="ta", state="done", error="", elapsed_s=4.0,
              report={"views_computed": 0})
    led.event("shed", scan="s3", tenant="ta", reason="queue wait", wait_s=9.0)
    led.close()
    with open(path, "a") as f:
        f.write(json.dumps({"type": "finish", "scan": "s3", "state": "done",
                            "epoch": 1}) + "\n")
        f.write('{"type": "complete", "item": "s3/vi')


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_and_usage_fold_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "ledger.jsonl")
    if writer == "port":
        _ledger_with_epochs(path)
    else:
        _script(jadm, path)
    port, jax = admission.replay_serving(path), jadm.replay_serving(path)
    assert port == jax
    assert admission.fold_usage(port) == jadm.fold_usage(jax)
    if writer == "port":
        assert port["max_epoch"] == 2 and port["stale_ignored"] == 1
        assert port["scans"]["s1"]["state"] == "done"
        assert port["scans"]["s3"]["state"] == "shed"
        assert port["tenant_fails"] == {"ta": 0, "tb": 1}
        usage = admission.fold_usage(port)
        assert usage["ta"]["views_completed"] == 1 and usage["tb"]["failed"] == 1


@pytest.mark.parametrize("writer", ["jax", "port", "jax-cli", "port-cli"])
def test_tenants_written_by_either_package_authenticate_in_both(tmp_path, writer, capsys):
    path = str(tmp_path / "tenants.json")
    if writer.endswith("cli"):
        main = jcli.main if writer.startswith("jax") else cli_main
        argv = ["tenant", "add", str(tmp_path), "alice", "--key", "k-alice"]
        extra = [] if writer.startswith("jax") else ["--device", "cpu"]
        assert main(argv + extra) == 0
        assert main(["tenant", "add", str(tmp_path), "bob", "--key", "k-bob",
                     "--rate-limit", "2", "--rate-window", "30"] + extra) == 0
        out = capsys.readouterr().out
        assert "API key (save it — shown once): k-bob" in out
    else:
        mod = PKGS[writer]
        mod.write_tenant(path, "alice", "k-alice")
        mod.write_tenant(path, "bob", "k-bob", rate_limit=2, rate_window_s=30.0)
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema"] == "sl3d-tenants-v1" and "k-alice" not in json.dumps(doc)
    cases = [("alice", ""), ("alice", "k-alice"), ("alice", "k-bob"), ("alice", "nope"),
             ("carol", "k-alice"), ("carol", "nope")]
    got = {}
    for name, mod in PKGS.items():
        auth = mod.TenantAuth(path)
        got[name] = ([None if (r := auth.check(t, k)) is None else r["reason"]
                      for t, k in cases],
                     auth.known(), auth.tenant_limits("bob"), auth.tenant_limits("alice"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [
        "auth-required", None, "auth-forbidden", "auth-invalid", "auth-forbidden",
        "auth-invalid"]
    assert got["port"][2] == (2, 30.0)


def test_the_rate_limiter_and_the_status_table_match(tmp_path):
    traces = {}
    for name, mod in PKGS.items():
        clk = FakeClock()
        lim = mod.RateLimiter(2, 10.0, clock=clk)
        trace = []
        for dt, tenant, over in ((0, "a", None), (1, "a", None), (1, "a", None),
                                 (1, "b", None), (0, "a", (1, 5.0)), (8, "a", None),
                                 (1, "a", None), (0, "a", (0, 1.0)), (20, "a", (3, 1.0))):
            clk.t += dt
            r = lim.allow(tenant, *over) if over else lim.allow(tenant)
            trace.append(None if r is None else (r["reason"], r["retry_after_s"]))
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    assert traces["port"][2] == ("rate-limited", 8.0)
    assert serving._REASON_HTTP == jserving._REASON_HTTP
    assert serving.REQUEST_SCHEMA == jserving.REQUEST_SCHEMA == "sl3d-request-v1"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["tenant", "list", str(tmp_path)])
    assert os.listdir(tmp_path) == []
