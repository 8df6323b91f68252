"""The port's elastic fleet (``parallel/fleet.py``) against the JAX
package's.

Exact, with no tolerance: ``decide`` over a parametrised grid of signals,
fleet sizes, idle times and bounds; ``FlapTracker``'s backoff, flap and
death counts over one schedule of deaths and retirements under an
injected clock; a ``FleetSupervisor`` of each package on fake processes
(no sockets, no children), driven through one script of ticks (scale-up,
death, backoff respawn at the next generation, flapping, scale-in,
retirement) under an injected clock, journals the same fleet events
(timestamps and pids aside) and ``replay_fleet`` of either journal folds
the same in both packages and equals the live supervisor's state. No
test here spawns a process; the fleet of real workers is in
``tests/test_torch_serving.py``.
"""
import itertools
import json
import os

import pytest

from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
from structured_light_for_3d_model_replication_tpu.parallel import admission as jadm
from structured_light_for_3d_model_replication_tpu.parallel import fleet as jfleet
from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.parallel import admission
from structured_light_for_3d_model_replication_tpu_torch.parallel import fleet

PKGS = {"jax": (jfleet, jadm, JConfig), "port": (fleet, admission, Config)}
SIG0 = {"queued_scans": 0, "active_scans": 0, "pending_items": 0, "granted_items": 0,
        "queue_wait_p50_s": 0.0, "queue_wait_p99_s": 0.0, "open_breakers": 0}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


GRID = [dict(SIG0, **over) for over in (
    {}, {"pending_items": 1}, {"pending_items": 9}, {"pending_items": 40},
    {"queued_scans": 2}, {"pending_items": 5, "queued_scans": 1},
    {"pending_items": 9, "open_breakers": 1}, {"open_breakers": 2},
    {"active_scans": 1}, {"granted_items": 3}, {"active_scans": 1, "granted_items": 2},
    {"pending_items": 3, "granted_items": 4, "queue_wait_p99_s": 7.5})]


@pytest.mark.parametrize("sig", GRID, ids=[f"sig{i}" for i in range(len(GRID))])
def test_decide_equals_the_jax_decide(sig):
    for live, idle, (lo, hi, q, idle_s) in itertools.product(
            (0, 1, 2, 4, 6), (0.0, 2.0, 5.0, 30.0),
            ((0, 4, 4, 5.0), (1, 2, 1, 0.0), (2, 8, 3, 10.0), (0, 0, 4, 5.0))):
        jp = jfleet.FleetParams(lo, hi, q, idle_s)
        pp = fleet.FleetParams(lo, hi, q, idle_s)
        assert fleet.decide(sig, live, idle, pp) == jfleet.decide(sig, live, idle, jp), \
            (sig, live, idle, lo, hi, q, idle_s)


def test_backoff_and_flap_schedules_equal_the_jax_ones():
    traces = {}
    for name, (mod, _, _) in PKGS.items():
        clk = FakeClock()
        ft = mod.FlapTracker(window_s=20.0, threshold=3, backoff_s=0.5,
                             backoff_max_s=3.0, clock=clk)
        trace = []
        for dt, rank, clean in ((0, 0, False), (1, 0, False), (1, 1, False),
                                (1, 0, False), (2, 0, False), (5, 1, True),
                                (15, 0, False), (30, 0, False), (1, 2, False)):
            clk.t += dt
            ft.record_exit(rank, clean=clean)
            trace.append([(ft.deaths(r), ft.flapping(r), ft.backoff(r)) for r in range(3)])
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    assert traces["port"][3][0] == (3, True, 3.0)      # the third death flaps


class FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.returncode = None

    def poll(self):
        return self.returncode

    def terminate(self):
        if self.returncode is None:
            self.returncode = 143

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        self.returncode = 137


def _supervisor_script(name: str, root: str) -> tuple[dict, dict]:
    mod, adm_mod, cfg_cls = PKGS[name]
    cfg = cfg_cls()
    cfg.serving.fleet_enabled = True
    cfg.serving.fleet_max_workers = 3
    cfg.serving.fleet_scale_up_queue = 4
    cfg.serving.fleet_backoff_s = 0.5
    cfg.serving.fleet_backoff_max_s = 4.0
    cfg.serving.fleet_flap_threshold = 2
    cfg.serving.fleet_scale_in_idle_s = 5.0
    clk = FakeClock()
    adm = adm_mod.AdmissionController(os.path.join(root, "ledger.jsonl"), "r",
                                      log=lambda m: None)
    sig = dict(SIG0)
    adm.signals = lambda: dict(sig)
    pids = itertools.count(50000)
    kw = {} if name == "jax" else {"device": "cpu"}
    sup = mod.FleetSupervisor(root, cfg, adm, os.path.join(root, "cache"),
                              steps=("statistical",), log=lambda m: None, clock=clk,
                              spawn_fn=lambda rank, gen: FakeProc(next(pids)), **kw)
    sig["pending_items"] = 9
    sup._tick()                                       # scale up to 3
    sup._workers[1]["proc"].returncode = 137
    sup._tick()                                       # fw1 dies: backoff 0.5
    clk.t += 0.5
    sup._tick()                                       # fw1 respawns, generation 1
    sup._workers[1]["proc"].returncode = 137
    sup._tick()                                       # dies again: flapping
    clk.t += 4.0
    sup._tick()                                       # respawn at the cap
    sig.update(pending_items=0)
    sup._tick()                                       # idle starts
    clk.t += 5.0
    sup._tick()                                       # scale in: retire all
    for w in list(sup._workers.values()):
        w["proc"].returncode = 0
    sup._tick()                                       # retired
    state = sup.state()
    adm.close()
    return state, mod.replay_fleet(os.path.join(root, "ledger.jsonl"))


def _fleet_events(path: str) -> list[dict]:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("t", "t0_unix")}
                for line in f if '"fleet"' in line]


def test_the_supervisor_journals_and_replays_as_the_jax_one(tmp_path):
    out = {}
    for name in PKGS:
        root = tmp_path / name
        root.mkdir()
        out[name] = _supervisor_script(name, str(root))
    for name in PKGS:
        state, replay = out[name]
        assert replay["live"] == state["live"] and replay["target"] == state["target"]
        strip = {k: v for k, v in state.items() if k not in ("pids", "hellos")}
        assert strip == {k: v for k, v in out["jax"][0].items()
                         if k not in ("pids", "hellos")}
    assert out["port"][1] == out["jax"][1]
    jev = _fleet_events(str(tmp_path / "jax" / "ledger.jsonl"))
    pev = _fleet_events(str(tmp_path / "port" / "ledger.jsonl"))
    assert pev == jev
    actions = [e["action"] for e in pev]
    assert actions.count("spawn") == 3 and actions.count("respawn") == 2
    assert "retired" in actions and "worker-exit" in actions
    for ledger in (tmp_path / "jax" / "ledger.jsonl", tmp_path / "port" / "ledger.jsonl"):
        assert fleet.replay_fleet(str(ledger)) == jfleet.replay_fleet(str(ledger))
