"""The port's multi-process mesh (``parallel/multihost.py``) on the CPU.

Two child processes join one gloo group through ``multihost.initialize``
(the JAX package's ``tests/test_multihost.py`` launcher shape: a free
port, a timeout), each bringing two local shards (``[cpu, cpu]``): the
summary shows 2 processes and 4 global devices, a ``psum`` of ones over
``global_mesh()`` is 4 on every shard, and the slab Laplacian of a grid
sharded across the rank boundary (``ppermute`` through the group) equals
the dense ``ops/poisson._laplacian`` bit for bit. A join whose peers never
come raises ``DeadlineExceeded`` naming the address and the topology.
"""
import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import torch
torch.set_num_threads(1)
addr, pid = sys.argv[1], int(sys.argv[2])
from structured_light_for_3d_model_replication_tpu_torch.parallel import mesh as meshlib
from structured_light_for_3d_model_replication_tpu_torch.parallel import multihost
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson, poisson_sharded
cpu = torch.device("cpu")
assert multihost.initialize(addr, num_processes=2, process_id=pid,
                            local_devices=[cpu, cpu]), "initialize returned False"
assert multihost.initialize(addr, num_processes=2, process_id=pid,
                            local_devices=[cpu, cpu])   # a second call is a no-op
assert multihost.is_multiprocess()
s = multihost.process_summary()
assert s == {"process_index": pid, "process_count": 2, "local_devices": 2,
             "global_devices": 4, "platform": "cpu"}, s
mesh = multihost.global_mesh()
assert mesh.size == 4 and mesh.local_slots() == [2 * pid, 2 * pid + 1], mesh
out = meshlib.psum(mesh, [torch.ones(()), torch.ones(())])
assert [float(o) for o in out] == [4.0, 4.0], out
g = meshlib.all_gather(mesh, [torch.tensor([2.0 * pid]), torch.tensor([2.0 * pid + 1])])
assert g[0].reshape(-1).tolist() == [0.0, 1.0, 2.0, 3.0], g
u = torch.from_numpy(__import__("numpy").random.default_rng(7).normal(
    size=(16, 6, 5)).astype("float32"))
mine = list(u.chunk(4))[2 * pid:2 * pid + 2]
lap = poisson_sharded.laplacian_sharded(mesh, mine)
ref = poisson._laplacian(u).chunk(4)[2 * pid:2 * pid + 2]
assert all(torch.equal(a, b) for a, b in zip(lap, ref))
print(f"proc{pid} ok", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(k, None)
    return env


def test_two_process_group_global_mesh_psum_and_halo():
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, addr, str(i)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc{i} rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        assert f"proc{i} ok" in out


def test_connect_timeout_names_the_address_and_topology():
    """Nothing else joins: the join is abandoned after the bound (in a
    child, so the abandoned thread dies with it; ``os._exit`` leaves it
    behind without waiting on the wedged rendezvous)."""
    port = _free_port()
    code = f"""
import os, sys, time
from structured_light_for_3d_model_replication_tpu_torch.parallel import multihost
from structured_light_for_3d_model_replication_tpu_torch.utils import deadline as dl
t0 = time.monotonic()
try:
    multihost.initialize("127.0.0.1:{port}", num_processes=2, process_id=0,
                         connect_timeout_s=2.0)
except dl.DeadlineExceeded as e:
    wall = time.monotonic() - t0
    assert "127.0.0.1:{port}" in str(e), str(e)
    assert "num_processes=2" in str(e), str(e)
    assert wall < 30.0, wall
    print("timeout ok %.1fs" % wall, flush=True)
    os._exit(0)
print("NO TIMEOUT", file=sys.stderr, flush=True)
os._exit(1)
"""
    p = subprocess.Popen([sys.executable, "-c", code], env=_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError("initialize() hung despite connect_timeout_s")
    assert p.returncode == 0, f"rc={p.returncode}\nstdout:{out}\nstderr:{err[-2000:]}"
    assert "timeout ok" in out


def test_initialize_without_settings_is_a_no_op_and_needs_both_settings():
    code = """
import os
from structured_light_for_3d_model_replication_tpu_torch.parallel import multihost
assert multihost.initialize() is False
assert not multihost.is_multiprocess()
assert multihost.process_summary() == {"process_index": 0, "process_count": 1,
    "local_devices": 1, "global_devices": 1, "platform": "cpu"}
assert multihost.global_mesh().size == 1
for kw in ({"num_processes": 2}, {"coordinator_address": "127.0.0.1:1"}):
    try:
        multihost.initialize(**kw)
    except ValueError as e:
        assert "address" in str(e) or "process count" in str(e), e
    else:
        raise AssertionError(kw)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
