"""The port's fault layer and deadline layer against the JAX package's
(``utils/faults.py``, ``utils/deadline.py``), exactly:

- one spec string, one seed and one sequence of ``fire(site, item)`` calls
  raise the same exception types at the same calls in both packages'
  ``FaultPlan`` (and ``counts()`` agree);
- ``RetryPolicy`` with jitter sleeps the same backoff sequence, drawn from
  the same seeded stream, and ``retry_call`` makes the same attempts;
- ``FailureRecord.as_dict`` has the same fields and values, and
  ``is_transient`` classifies the same exceptions the same way;
- the watchdog on a fake lane (a heartbeat, then silence past the soft and
  the hard stall) records the same breach levels, cancels the token on the
  hard one, and lowers the cancel level when the lane beats again.

Also the port's profiling hooks: ``OverlapStats.add`` is the watchdog's
heartbeat, and ``profiling.trace`` writes one torch.profiler Chrome trace
for nested blocks.
"""
import errno
import threading
import time

import pytest

from structured_light_for_3d_model_replication_tpu.utils import deadline as jdl
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

PACKAGES = {"port": (faults, dl), "jax": (jfaults, jdl)}
SPEC = ("frame.load:transient@2x3,compute.view~view_3:permanent,"
        "cache.get:transient%0.5,register.pair~1->2:crash,ply.write:slow(0)x2")


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.reset()
    jfaults.reset()


def _drive(mod, seed):
    plan = mod.FaultPlan.from_spec(SPEC, seed)
    out = []
    for n in range(240):
        site = ("frame.load", "compute.view", "cache.get", "register.pair",
                "ply.write")[n % 5]
        item = f"view_{n % 7}" if site != "register.pair" else f"{n % 3}->{n % 3 + 1}"
        try:
            plan.fire(site, item)
            out.append(None)
        except BaseException as e:   # InjectedCrash is a BaseException
            out.append((n, site, item, type(e).__name__, e.transient
                        if isinstance(e, mod.InjectedFault) else None))
    return out, plan.counts()


@pytest.mark.parametrize("seed", [0, 7])
def test_one_spec_fires_the_same_sequence(seed):
    port, jax = _drive(faults, seed), _drive(jfaults, seed)
    assert port == jax
    fired = [x for x in port[0] if x]
    assert {x[3] for x in fired} == {"TransientFault", "PermanentFault", "InjectedCrash"}
    assert port[1]["frame.load"] == 3 and port[1]["ply.write"] == 2


def test_retry_policy_backoff_and_attempts_match():
    seen = {}
    for name, (mod, _) in PACKAGES.items():
        mod.configure("none.site:transient", seed=3)   # seeds the jitter stream
        policy = mod.RetryPolicy(max_retries=4, backoff_base_s=0.05,
                                 backoff_max_s=0.3, jitter=True)
        sleeps, calls = [], []

        def flaky(mod=mod, calls=calls):
            calls.append(1)
            if len(calls) < 4:
                raise mod.TransientFault("blip")
            return "ok"

        assert mod.retry_call(flaky, policy, sleep=sleeps.append) == "ok"
        ceilings = [policy.delay_s(n) for n in range(1, 6)]
        with pytest.raises(mod.PermanentFault) as ei:
            mod.retry_call(lambda: (_ for _ in ()).throw(mod.PermanentFault("bad")),
                           policy, sleep=sleeps.append)
        seen[name] = (sleeps, len(calls), ceilings, ei.value._sl3d_attempts)
    assert seen["port"] == seen["jax"]
    sleeps, n_calls, ceilings, attempts = seen["port"]
    assert n_calls == 4 and attempts == 1 and len(sleeps) == 3
    assert ceilings == [0.05, 0.1, 0.2, 0.3, 0.3]
    assert all(0 <= s <= c for s, c in zip(sleeps, ceilings))


def _exceptions(mod, dmod):
    t = mod.annotate(mod.TransientFault("blip"), stage="load", attempts=3)
    return [t, mod.PermanentFault("bad view"), OSError(errno.EAGAIN, "again"),
            OSError(errno.ENOENT, "gone"), dmod.DeadlineExceeded("late"),
            dmod.Cancelled("cancelled"), ConnectionResetError("reset"),
            RuntimeError("CUDA error"), ValueError("shape")]


def test_failure_records_and_classification_match():
    rows = {}
    for name, (mod, dmod) in PACKAGES.items():
        rows[name] = [(mod.is_transient(e),
                       mod.FailureRecord.from_exception("compute", "view_001", e).as_dict())
                      for e in _exceptions(mod, dmod)]
    assert rows["port"] == rows["jax"]
    first = rows["port"][0][1]
    assert first == {"stage": "load", "view": "view_001", "attempts": 3,
                     "error_type": "TransientFault", "message": "blip", "transient": True}
    # a CUDA launch error is permanent: its view is quarantined, never retried
    assert [t for t, _ in rows["port"]] == [True, False, True, False, True, False,
                                            True, False, False]


def _watch(dmod):
    token = dmod.CancelToken()
    wd = dmod.Watchdog(soft_stall_s=0.2, hard_stall_s=1.5, token=token, poll_s=0.02)
    wd.start()
    wd.beat("compute")
    t_end = time.monotonic() + 5.0
    while not token.cancelled and time.monotonic() < t_end:
        time.sleep(0.01)
    cancelled = token.cancelled
    wd.beat("compute")
    t_end = time.monotonic() + 2.0
    while token.cancelled and time.monotonic() < t_end:
        time.sleep(0.01)
    wd.stop()
    return [b["level"] for b in wd.breaches], cancelled, token.cancelled, \
        sorted(wd.breaches[0]["lane_ages"])


def test_watchdog_breaches_match_on_a_fake_lane():
    out = {}
    threads = [threading.Thread(target=lambda n=n, d=d: out.__setitem__(n, _watch(d)))
               for n, (_, d) in PACKAGES.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out["port"] == out["jax"] == (["soft", "hard"], True, False, ["compute"])


def test_a_cancelled_stall_raises_and_the_budget_bounds_waits():
    token = dl.CancelToken()
    threading.Timer(0.05, token.cancel, args=("stop",)).start()
    t0 = time.monotonic()
    with pytest.raises(dl.Cancelled, match="stop"):
        dl.sleep_cancellable(5.0, token=token, what="stall")
    assert time.monotonic() - t0 < 2.0
    from concurrent.futures import Future

    with pytest.raises(dl.DeadlineExceeded):
        dl.wait_future(Future(), 0.05, what="wedged")
    assert dl.Deadline.after(0) is None and dl.Deadline.after(1.0).remaining() > 0


def test_lane_accounting_beats_the_watchdog_and_trace_nests(tmp_path, monkeypatch):
    import json

    import torch

    from structured_light_for_3d_model_replication_tpu_torch.utils import profiling as prof

    ctx = dl.RunContext()
    ctx.watchdog = dl.Watchdog(60.0, 300.0, ctx.token, poll_s=10.0)
    prev = dl.activate(ctx)
    try:
        stats = prof.OverlapStats()
        stats.add("clean", 0.25, view="v0")
        stats.add_pair_launch(3, 0.5)
        assert set(ctx.watchdog.lane_ages()) == {"clean", "register"}
    finally:
        dl.deactivate(prev)
    stats.finish(0.5)
    d = stats.as_dict()
    assert (d["clean_s"], d["register_s"], d["pairs_dispatched"]) == (0.25, 0.5, 3)
    assert d["overlap_ratio"] == 1.5
    monkeypatch.setenv("SL3D_TRACE_DIR", str(tmp_path / "prof"))
    with prof.trace():
        with prof.trace():   # the inner block lands in the outer capture
            torch.ones(8).sum()
    files = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())
