"""The port's blob fabric (``pipeline/blobstore.py``) against the JAX
package's, across the wire in both directions.

Each case runs a blob server of one package and clients (raw
``BlobClient`` and the two-level ``FabricCache``) of the other, so the
wire messages, the blob names, the secret handshake and the cache's
payload layout must agree byte for byte: push and fetch return the pushed
bytes, a repeat push dedups, the server's counters count what the clients
moved, a wrong or missing secret reads every call as a miss, a blob that
fails the stage cache's verification promotes, evicts and reads as a miss,
and an endpoint with no server reads as a miss within its connect
timeout. The ``FabricCache`` cases check promotion into a cold private
L1 (one fetch, then L1 hits) and the inventory diff (drained once,
requeued on a failed heartbeat, promotions included).
"""
import os
import time

import numpy as np
import pytest

from structured_light_for_3d_model_replication_tpu.pipeline import blobstore as jblob
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.pipeline import blobstore
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

PACKAGES = {"jax": jblob, "port": blobstore}
# (server package, client package)
DIRECTIONS = [("jax", "port"), ("port", "jax")]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(params=DIRECTIONS, ids=lambda d: f"{d[0]}-server-{d[1]}-client")
def wire(request, tmp_path):
    srv_mod, cli_mod = (PACKAGES[k] for k in request.param)
    srv = srv_mod.BlobServer(str(tmp_path / "l2"), port=0)
    clients = []

    def client(secret=""):
        c = cli_mod.BlobClient(srv.endpoint, secret=secret, connect_timeout_s=5.0,
                               io_timeout_s=5.0)
        clients.append(c)
        return c

    yield srv, cli_mod, client
    for c in clients:
        c.close()
    srv.close()


def _counters(srv, settle_s=5.0, **want):
    """The server's counters once ``want`` holds, or after ``settle_s``: a
    server counts a fetch after it has flushed the blob, from the
    connection's own thread, so the client may return first."""
    deadline = time.monotonic() + settle_s
    got = srv.counters()
    while any(got[k] != v for k, v in want.items()) and time.monotonic() < deadline:
        time.sleep(0.01)
        got = srv.counters()
    return got


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"points": rng.normal(size=(40, 3)).astype(np.float32),
            "colors": rng.integers(0, 256, size=(40, 3), dtype=np.uint8)}


def test_push_fetch_and_dedup_across_packages(wire):
    srv, _, client = wire
    data = os.urandom(4096)
    c = client()
    assert c.push("view-aaaa1111bbbb2222", data) == "pushed"
    assert client().fetch("view-aaaa1111bbbb2222") == data
    assert c.push("view-aaaa1111bbbb2222", data) == "deduped"
    assert c.fetch("view-0000000000000000") is None
    assert c.push("../escape", b"x") is None
    got = _counters(srv, pushes=1, fetches=1, dedups=1, misses=1)
    assert (got["pushes"], got["fetches"], got["dedups"], got["misses"]) == (1, 1, 1, 1)
    assert got["bytes_pushed"] == got["bytes_fetched"] == got["bytes_deduped"] == 4096
    assert srv.names() == ["view-aaaa1111bbbb2222"]


@pytest.mark.parametrize("direction", DIRECTIONS, ids=lambda d: f"{d[0]}-server")
def test_the_shared_secret_gates_both_ways(direction, tmp_path):
    srv_mod, cli_mod = (PACKAGES[k] for k in direction)
    srv = srv_mod.BlobServer(str(tmp_path / "l2"), port=0, secret="scan-pod-1")
    try:
        bad = cli_mod.BlobClient(srv.endpoint, secret="nope", connect_timeout_s=5.0)
        anon = cli_mod.BlobClient(srv.endpoint, connect_timeout_s=5.0)
        good = cli_mod.BlobClient(srv.endpoint, secret="scan-pod-1",
                                  connect_timeout_s=5.0)
        assert bad.push("view-aaaa", b"data") is None
        assert bad.fetch("view-aaaa") is None
        assert anon.fetch("view-aaaa") is None
        assert good.push("view-aaaa", b"data") == "pushed"
        assert good.fetch("view-aaaa") == b"data"
        assert anon.fetch("view-aaaa") is None
        for c in (bad, anon, good):
            c.close()
    finally:
        srv.close()
    assert srv.names() == ["view-aaaa"]


def test_a_corrupt_blob_reads_as_a_miss(wire, tmp_path):
    """A blob whose bytes cross the wire intact but fail the stage cache's
    ``__key__``/``__digest__`` check promotes into L1, evicts, and reads as
    a miss; a torn server file is never handed out as the pushed bytes."""
    srv, cli_mod, client = wire
    plain = cli_mod.FabricCache(str(tmp_path / "scratch"), None)
    key = plain.key("view", config_json="{}")
    plain.put("view", key, **_arrays())
    blob = bytearray(open(plain._path("view", key), "rb").read())
    for i in range(len(blob) // 2, len(blob) // 2 + 16):
        blob[i] ^= 0xFF
    assert client().push(f"view-{key[:16]}", bytes(blob)) == "pushed"
    cache = cli_mod.FabricCache(str(tmp_path / "w0"), client())
    assert cache.get("view", key) is None
    assert not os.path.exists(cache._path("view", key))
    assert cache.stats()["evicted"] == 1
    data = os.urandom(512)
    c = client()
    assert c.push("view-feed", data) == "pushed"
    with open(os.path.join(srv.root, "view-feed.npz"), "wb") as f:
        f.write(data[:100])
    assert c.fetch("view-feed") != data


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_an_unreachable_endpoint_is_a_miss_within_its_timeout(mod):
    cli = PACKAGES[mod].BlobClient("127.0.0.1:1", connect_timeout_s=0.3, io_timeout_s=0.3)
    t0 = time.monotonic()
    assert cli.fetch("view-aaaa") is None
    assert cli.push("view-aaaa", b"x") is None
    assert time.monotonic() - t0 < 10.0
    cli.close()


def test_fabric_cache_promotes_into_a_cold_l1(wire, tmp_path):
    """A producer of one package writes through its cache; a consumer of
    the other with a cold private L1 fetches once, promotes, and then reads
    its L1. Both caches see the same arrays under the same key."""
    srv, cli_mod, client = wire
    srv_mod = blobstore if cli_mod is jblob else jblob
    producer = srv_mod.FabricCache(
        str(tmp_path / "w0"), srv_mod.BlobClient(srv.endpoint, connect_timeout_s=5.0))
    key = producer.key("view", config_json="{}")
    producer.put("view", key, **_arrays())
    assert srv.counters()["pushes"] == 1 and producer.drain_inventory() == [
        f"view-{key[:16]}"]
    consumer = cli_mod.FabricCache(str(tmp_path / "w1"), client())
    assert consumer.drain_inventory() == []
    out = consumer.get("view", key)
    for k, v in _arrays().items():
        np.testing.assert_array_equal(out[k], v)
    assert os.path.exists(consumer._path("view", key))
    consumer.get("view", key)
    assert _counters(srv, fetches=1)["fetches"] == 1
    assert consumer.drain_inventory() == [f"view-{key[:16]}"]


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_the_inventory_diff_drains_once_and_requeues(mod, tmp_path):
    fabric = PACKAGES[mod].FabricCache
    cache = fabric(str(tmp_path / "w0"), None)
    k1 = cache.key("view", config_json='{"v": 1}')
    k2 = cache.key("view", config_json='{"v": 2}')
    cache.put("view", k1, **_arrays(1))
    cache.put("view", k2, **_arrays(2))
    diff = cache.drain_inventory()
    assert diff == sorted([f"view-{k1[:16]}", f"view-{k2[:16]}"])
    assert cache.drain_inventory() == []
    cache.requeue_inventory(diff)
    assert cache.drain_inventory() == diff
    assert fabric(str(tmp_path / "w0"), None).local_names() == diff
    assert fabric(str(tmp_path / "empty"), None).local_names() == []
