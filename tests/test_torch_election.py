"""The port's leader election (``parallel/election.py``) against the JAX
package's, over one root and one injected clock.

Exact, with no tolerance: two leases over one ``leader.json``, one of each
package (and, as the reference, two of the JAX package), run one script of
interleaved acquire / renew / expiry / takeover / fence / release and give
the same results and the same epochs step by step; each package's
``fence`` rejects the other's deposed writer; a lease file written by
either package reads the same in the other; a ledger stamped and fenced by
the port's election replays in both packages to the same fold; the
``election.acquire`` / ``election.renew`` sites fire before the flock in
both packages.
"""
import json

import pytest

from structured_light_for_3d_model_replication_tpu.parallel import election as jelection
from structured_light_for_3d_model_replication_tpu.parallel.admission import (
    replay_serving as jreplay,
)
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.parallel import election
from structured_light_for_3d_model_replication_tpu_torch.parallel.admission import (
    replay_serving,
)
from structured_light_for_3d_model_replication_tpu_torch.parallel.coordinator import Ledger
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

PKGS = {"jax": jelection, "port": election}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()
    jfaults.reset()


def _fenced(lease) -> bool:
    try:
        lease.fence()
    except (jelection.FencedWrite, election.FencedWrite):
        return True
    return False


def _script(path: str, pkg_a: str, pkg_b: str) -> list:
    """One run of the interleaved protocol; returns its trace."""
    clk = FakeClock()
    a = PKGS[pkg_a].LeaderLease(path, "gwA", lease_s=5.0, clock=clk)
    b = PKGS[pkg_b].LeaderLease(path, "gwB", lease_s=5.0, clock=clk)
    trace = []

    def rec(what, value):
        cur = a.current() or {}
        trace.append((what, value, a.epoch, b.epoch, cur.get("owner"),
                      cur.get("epoch"), cur.get("expires_unix")))

    rec("a.acquire", a.acquire())
    rec("b.acquire live", b.acquire())
    clk.t += 3.0
    rec("a.renew", a.renew())
    rec("a.acquire again", a.acquire())          # our own lease: no bump
    clk.t += 6.0                                 # a stalls past its lease
    rec("b.acquire expired", b.acquire())        # takeover: epoch 2
    rec("a.fenced", _fenced(a))
    rec("a.superseded", a.superseded())
    rec("b.fenced", _fenced(b))
    rec("a.renew deposed", a.renew())
    clk.t += 2.0
    rec("b.renew", b.renew())
    clk.t += 6.0
    rec("a.acquire expired", a.acquire())        # epoch 3
    rec("b.fenced", _fenced(b))
    rec("b.renew deposed", b.renew())
    a.release()                                  # graceful step-down
    rec("a.released", a.epoch)
    rec("b.acquire released", b.acquire())       # no wait: epoch 4
    rec("a.fenced stale", _fenced(a))            # a holds epoch 0
    return trace


@pytest.mark.parametrize("pkgs", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_interleaved_leases_give_the_jax_epochs(tmp_path, pkgs):
    (tmp_path / "ref").mkdir()
    ref = _script(str(tmp_path / "ref" / "leader.json"), "jax", "jax")
    got = _script(str(tmp_path / "leader.json"), *pkgs)
    assert got == ref
    assert [t[2:4] for t in got if t[0] == "b.acquire released"] == [(0, 4)]
    with open(tmp_path / "leader.json") as f:
        rec = json.load(f)
    assert rec["schema"] == "sl3d-leader-v1" and rec["epoch"] == 4


def test_each_package_fences_the_others_deposed_writer(tmp_path):
    clk = FakeClock()
    path = str(tmp_path / "leader.json")
    for old_pkg, new_pkg in (("jax", "port"), ("port", "jax")):
        old = PKGS[old_pkg].LeaderLease(path, f"old-{old_pkg}", lease_s=1.0, clock=clk)
        new = PKGS[new_pkg].LeaderLease(path, f"new-{new_pkg}", lease_s=1.0, clock=clk)
        assert old.acquire()
        clk.t += 2.0
        assert new.acquire() and new.epoch == old.epoch + 1
        with pytest.raises(PKGS[old_pkg].FencedWrite, match="fenced by epoch"):
            old.fence()
        new.fence()
        assert new.current() == old.current()    # one file, read by both
        new.release()
        clk.t += 1.0


def test_a_fenced_ledger_replays_the_same_in_both_packages(tmp_path):
    """The admission ledger of a leader that was deposed: its epoch-1 lines,
    the new leader's epoch-2 lines, then a zombie line of epoch 1 written
    past the fence (as a raced append would land) and a torn tail."""
    clk = FakeClock()
    path = str(tmp_path / "leader.json")
    ledger_path = str(tmp_path / "ledger.jsonl")
    a = election.LeaderLease(path, "gwA", lease_s=1.0, clock=clk)
    b = election.LeaderLease(path, "gwB", lease_s=1.0, clock=clk)
    assert a.acquire()
    la = Ledger(ledger_path, "ra", meta={"mode": "serving"},
                epoch=lambda: a.epoch, fence=a.fence)
    la.event("submit", scan="s1", tenant="t", target="/x", calib="/c", out_dir="/o",
             weight=1.0, budget_s=0.0)
    la.event("complete", item="s1/view:0", scan="s1", tenant="t", worker="lane0", gen=1)
    clk.t += 2.0
    assert b.acquire()
    with pytest.raises(election.FencedWrite):
        la.event("complete", item="s1/view:1", scan="s1", tenant="t", worker="lane0",
                 gen=1)
    lb = Ledger(ledger_path, "rb", meta={"mode": "serving"},
                epoch=lambda: b.epoch, fence=b.fence)
    lb.event("complete", item="s1/view:2", scan="s1", tenant="t", worker="lane0", gen=1)
    la.close()
    lb.close()
    with open(ledger_path, "a") as f:
        f.write(json.dumps({"type": "complete", "item": "s1/view:3", "epoch": 1}) + "\n")
        f.write('{"type": "finish", "scan": "s1", "sta')
    port, jax = replay_serving(ledger_path), jreplay(ledger_path)
    assert port == jax
    assert port["completed"] == {"s1/view:0", "s1/view:2"}
    assert port["max_epoch"] == 2 and port["stale_ignored"] == 1
    with open(ledger_path) as f:
        lines = [json.loads(x) for x in f.read().splitlines()[:-1]]
    assert all("epoch" in rec for rec in lines)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_election_sites_fire_before_the_flock(tmp_path, pkg):
    mod = PKGS[pkg]
    fmod = jfaults if pkg == "jax" else faults
    clk = FakeClock()
    a = mod.LeaderLease(str(tmp_path / "leader.json"), "gwA", lease_s=5.0, clock=clk)
    fmod.configure("election.acquire~gwA:transient,election.renew~gwA:transient")
    with pytest.raises(fmod.TransientFault):
        a.acquire()
    assert a.acquire() and a.epoch == 1
    with pytest.raises(fmod.TransientFault):
        a.renew()
    assert a.epoch == 1 and a.renew()
    # the lock file is free: a second handle's flock'd acquire proceeds
    b = mod.LeaderLease(str(tmp_path / "leader.json"), "gwB", lease_s=5.0, clock=clk)
    assert not b.acquire()
