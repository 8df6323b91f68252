"""The port's lease table, locality index and endpoint grammar against the
JAX package's (``parallel/lease.py``, ``parallel/netutil.py``).

The port keeps its own copies of these modules (it imports nothing of the
JAX package); each case drives both with the same event sequence on a fake
clock, or the same strings, and every answer must be equal: grants and
their generations, renewals, accepted and stale completes, expiries,
steals, dropped workers, locality choices and counters, parsed endpoints
and raised errors.
"""
import pytest

from structured_light_for_3d_model_replication_tpu.parallel import lease as jlease
from structured_light_for_3d_model_replication_tpu.parallel import netutil as jnet
from structured_light_for_3d_model_replication_tpu_torch.parallel import lease
from structured_light_for_3d_model_replication_tpu_torch.parallel import netutil


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _drive(mod, events):
    """Run ``events`` through ``mod.LeaseTable`` (lease_s 10) on a fake
    clock; returns every answer, exceptions as their type name."""
    clock = FakeClock()
    table = mod.LeaseTable(lease_s=10.0, clock=clock)
    out = []
    for ev in events:
        op, *args = ev
        try:
            if op == "tick":
                clock.t += args[0]
                r = None
            elif op == "grant":
                g = table.grant(*args)
                r = (g.item, g.worker, g.gen, g.expires_at)
            elif op == "expired":
                r = sorted((x.item, x.worker, x.gen) for x in table.expired())
            else:
                r = getattr(table, op)(*args)
        except Exception as e:   # a coordinator bug is an answer too
            r = type(e).__name__
        out.append(r)
    out.append((table.active_count(), table.holder("view:0"), table.gen("view:0"),
                table.steals("view:0"), table.worker_items("w0")))
    return out


_SEQUENCES = {
    "grant-complete": [("grant", "view:0", "w0"), ("complete", "view:0", "w0", 0),
                       ("complete", "view:0", "w0", 0)],
    "double-grant": [("grant", "view:0", "w0"), ("grant", "view:0", "w1")],
    "expiry-steal-late-complete": [
        ("grant", "view:0", "w0"), ("tick", 9.9), ("expired",), ("tick", 0.2),
        ("expired",), ("steal", "view:0"), ("grant", "view:0", "w1"),
        ("complete", "view:0", "w0", 0), ("complete", "view:0", "w1", 1)],
    "renew-keeps-every-lease": [
        ("grant", "view:0", "w0"), ("grant", "pair:0", "w0"), ("grant", "view:1", "w1"),
        ("tick", 8.0), ("renew", "w0"), ("tick", 8.0), ("expired",), ("renew", "w9")],
    "drop-worker": [
        ("grant", "view:0", "w0"), ("grant", "view:1", "w0"), ("grant", "view:2", "w1"),
        ("drop_worker", "w0"), ("steals", "view:1"), ("grant", "view:0", "w1"),
        ("drop_worker", "w1"), ("steal", "view:0")],
    "steals-accumulate": [
        ("grant", "view:0", "w0"), ("steal", "view:0"), ("grant", "view:0", "w1"),
        ("steal", "view:0"), ("grant", "view:0", "w0"), ("tick", 11.0), ("expired",),
        ("steal", "view:0"), ("steals", "view:0")],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_lease_table_matches_the_jax_package(name):
    events = _SEQUENCES[name]
    assert _drive(lease, events) == _drive(jlease, events)


def test_lease_table_refuses_a_non_positive_lease():
    for mod in (lease, jlease):
        with pytest.raises(ValueError):
            mod.LeaseTable(lease_s=0.0)


def _locality(mod, events):
    idx = mod.LocalityIndex()
    out = []
    for op, *args in events:
        out.append(getattr(idx, op)(*args))
    out.append(idx.counters())
    return out


_PAIRS = [("view:3", None), ("pair:0", ("view-a", "view-b")),
          ("pair:1", ("view-b", "view-c"))]
_LOCALITY = {
    "cold-worker-takes-the-head": [("choose", "w0", _PAIRS)],
    "both-endpoints-held": [("update", "w0", ["view-b", "view-c"]),
                            ("choose", "w0", _PAIRS), ("choose", "w1", _PAIRS[1:])],
    "one-endpoint-is-a-miss": [("update", "w0", ["view-a"]),
                               ("choose", "w0", _PAIRS[1:]), ("holds", "w0", "view-a")],
    "dropped-worker-forgets": [("update", "w1", ["view-a", "view-b"]),
                               ("drop_worker", "w1"), ("choose", "w1", _PAIRS[1:]),
                               ("holds", "w1", "view-a"), ("update", "w1", [])],
    "no-candidates": [("choose", "w0", [])],
}


@pytest.mark.parametrize("name", sorted(_LOCALITY))
def test_locality_index_matches_the_jax_package(name):
    events = _LOCALITY[name]
    assert _locality(lease, events) == _locality(jlease, events)


def _parse(mod, text, **kw):
    try:
        return mod.parse_endpoint(text, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("text", [
    "", "10.0.0.7:9100", "[::1]:9100", "[::1]", "[]:80", ":9100", "9100", "host:",
    "host", "  127.0.0.1:0 ", "::1:9100", "[::1", "[::1]x", "h:abc", "h:70000",
    "0.0.0.0:65535"])
def test_endpoint_grammar_matches_the_jax_package(text):
    assert _parse(netutil, text) == _parse(jnet, text)
    assert _parse(netutil, text, default_host="::", default_port=7) == \
        _parse(jnet, text, default_host="::", default_port=7)
    got = _parse(netutil, text)
    if got[0] != "ValueError":
        formatted = netutil.format_endpoint(*got)
        assert formatted == jnet.format_endpoint(*got)
        assert netutil.parse_endpoint(formatted) == got   # the round trip re-parses


@pytest.mark.parametrize("tag", [("fw0", 0), ("fw0", 2), ("w1", 11), ("a#gb", 0)])
def test_worker_tags_match_the_jax_package(tag):
    text = netutil.worker_tag(*tag)
    assert text == jnet.worker_tag(*tag)
    assert netutil.parse_worker_tag(text) == jnet.parse_worker_tag(text)
    assert netutil.parse_worker_tag("w0#gx") == jnet.parse_worker_tag("w0#gx")
