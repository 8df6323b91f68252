"""The port's coordinated multiprocess pipeline on the CPU, against the
port's single-process run and the JAX package's coordinator.

The scene is the JAX package's coordinator test scene
(``tests/test_coordinator.py``): 5 synthetic views at a 96x72 camera and a
64x32 projector, the statistical clean step, the merged cloud's outlier
pass off (``merge.outlier_nb=0``), so a run holds 5 view items and 4
streamed pair items. Workers are spawned processes of the port (or,
in the numpy-backend case, of each package), on ``device="cpu"``; spawned
workers inherit ``OMP_NUM_THREADS=1``, as this process pins torch to one
thread. Four tests spawn workers; every wait is bounded (the coordinator's
``pipeline.run_budget_s``, its connect timeouts, its teardown). Tolerances:

- byte for byte: ``merged.ply`` and ``model.stl`` of a 2-worker run equal
  the port's single-process run's, clean (loopback), with worker w0
  killed on its first item (the pod fabric: ``coordinator.listen``, a
  shared secret, private L1 roots, ``merge.incremental`` and the flight
  recorder on), and after a coordinator crash on its 3rd grant and a
  resume into the same directory (zero recompute: the resumed run leases
  only the items the ledger does not credit);
- with the numpy backend, each cleaned view's payload (points, colors) of
  the port's 2-worker coordinated run equals the JAX package's coordinated
  run's (one worker) byte for byte, and the merged clouds are within 1 mm chamfer distance
  (the rule of ``test_torch_pipeline.py``: the merge's RANSAC draws differ
  between the packages);
- a ledger written by either package replays in the other to the same
  completed set, a torn tail and several segments included;
- a pair registered in a group gives the bytes it gives alone, and every
  ICP step update sees ``merge.pair_batch`` lanes, alone or in a group (a
  spy on ``_icp_step_update``: on the card a batched step's rounding
  follows its shape, so a worker's pair item and the streamed lane's
  group must step at one shape);
- a spec that asks for ``cuda`` on this CPU host makes the worker raise
  ``resolve_device``'s error before it dials anyone: no item computed.
"""
import json
import os

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.config import Config as JConfig
from structured_light_for_3d_model_replication_tpu.parallel import coordinator as jcoord
from structured_light_for_3d_model_replication_tpu.pipeline import stages as jstages
from structured_light_for_3d_model_replication_tpu.pipeline.stagecache import (
    StageCache as JStageCache,
)
from structured_light_for_3d_model_replication_tpu.utils import faults as jfaults
from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.io import ply
from structured_light_for_3d_model_replication_tpu_torch.parallel import coordinator
from structured_light_for_3d_model_replication_tpu_torch.pipeline import report as replib
from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
)
from structured_light_for_3d_model_replication_tpu_torch.utils import faults

VIEWS = 5
STEPS = ("statistical",)
N_ITEMS = VIEWS + (VIEWS - 1)
BUDGET_S = 300.0     # pipeline.run_budget_s of every coordinated run here


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("SL3D_FAULTS", raising=False)
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coordds"))
    assert cli_main(["synth", root, "--views", str(VIEWS), "--cam", "96x72",
                     "--proj", "64x32"]) == 0
    return root


def _setup(cfg, workers: int = 0, backend: str = "torch"):
    if backend == "numpy":
        cfg.parallel.backend = "numpy"
    cfg.decode.n_cols, cfg.decode.n_rows = 64, 32
    cfg.decode.thresh_mode = "manual"
    cfg.merge.voxel_size = 4.0
    cfg.merge.ransac_trials = 256
    cfg.merge.icp_iters = 6
    cfg.mesh.depth = 5
    cfg.mesh.density_trim_quantile = 0.0
    # the merged cloud's outlier pass is the single-process code in every arm;
    # off, it saves its plain k-NN mean's ~5 s a run on the CPU
    cfg.merge.outlier_nb = 0
    cfg.coordinator.workers = workers
    cfg.pipeline.run_budget_s = BUDGET_S
    return cfg


def _run(dataset, out, cfg):
    return stages.run_pipeline(os.path.join(dataset, "calib.mat"), dataset, out, cfg=cfg,
                               steps=STEPS, log=lambda m: None, device="cpu")


def _bytes(out, name):
    with open(os.path.join(out, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def baseline(dataset, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coord_sp"))
    rep = _run(dataset, out, _setup(Config()))
    assert rep.failed == [] and not rep.degraded and rep.coordinator is None
    return _bytes(out, "merged.ply"), _bytes(out, "model.stl")


def _assert_parity(baseline, out):
    assert _bytes(out, "merged.ply") == baseline[0], "merged.ply differs"
    assert _bytes(out, "model.stl") == baseline[1], "model.stl differs"


def _events(out):
    with open(os.path.join(out, "ledger.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# the ledger, across packages (no workers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ledger_replays_the_same_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    mod = jcoord if writer == "jax" else coordinator
    assert mod.LEDGER_SCHEMA == coordinator.LEDGER_SCHEMA == jcoord.LEDGER_SCHEMA
    led = mod.Ledger(path, run_id="r1", meta={"workers": 2})
    led.event("grant", item="view:0", worker="w0", gen=0)
    led.event("complete", item="view:0", worker="w0", gen=0)
    led.event("grant", item="view:1", worker="w1", gen=0)
    led.event("steal", item="view:1", worker="w1", gen=1, reason="lease-expired")
    led.event("late-complete", item="view:1", worker="w1", gen=0)
    led.close()
    led = mod.Ledger(path, run_id="r2", meta={})   # a resumed coordinator's segment
    led.event("complete", item="pair:0", worker="w0", gen=0)
    led.close()
    with open(path, "a") as f:
        f.write('{"type": "complete", "item": "view:2", "wor')   # torn tail
    mine, theirs = coordinator.Ledger.replay(path), jcoord.Ledger.replay(path)
    assert mine == theirs
    assert mine["completed"] == {"view:0", "pair:0"} and mine["segments"] == 2
    with open(str(tmp_path / "bad.jsonl"), "w") as f:
        f.write(json.dumps({"type": "meta", "schema": "bogus-v9", "run_id": "r"}) + "\n")
    with pytest.raises(ValueError):
        coordinator.Ledger.replay(str(tmp_path / "bad.jsonl"))


def test_a_cuda_spec_on_a_cpu_host_computes_nothing(dataset, tmp_path):
    """The device comes from the spec alone: ``cuda`` on a host without
    CUDA raises ``resolve_device``'s error (the process exits non-zero)
    before the worker dials the coordinator, warms a cache or opens a
    journal."""
    assert not torch.cuda.is_available()
    cfg_path = str(tmp_path / "cfg.json")
    cfg = _setup(Config())
    cfg.observability.trace = True
    cfg.save(cfg_path)
    out = tmp_path / "out"
    out.mkdir()
    spec = {"config": cfg_path, "calib": os.path.join(dataset, "calib.mat"),
            "target": dataset, "out": str(out), "steps": list(STEPS), "port": 1,
            "worker": "w0", "num_workers": 1, "device": "cuda"}
    (tmp_path / "worker0.json").write_text(json.dumps(spec))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["worker", "--spec", str(tmp_path / "worker0.json")])
    assert os.listdir(out) == []


def test_a_pairs_registration_does_not_depend_on_its_group(monkeypatch):
    """A worker registers one pair an item, the streamed lane in groups of
    ``merge.pair_batch``: every ICP step update must run at the one lane
    count ``merge.pair_batch`` (on the card a batched step rounds by its
    shape), and a pair's transform must be the same bytes alone and in a
    group."""
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import registration as reg

    rng = np.random.default_rng(11)
    theta = rng.uniform(0, 2 * np.pi, 1500)
    phi = rng.uniform(0.2, 2.9, 1500)
    sphere = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                       np.cos(phi)], 1) * 40.0
    base = np.concatenate([sphere, sphere * 0.5 + [60.0, 0.0, 0.0]]).astype(np.float32)
    clouds = []
    for k in range(4):
        c, s_ = np.cos(0.05 * k), np.sin(0.05 * k)
        R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
        clouds.append((base @ R.T + rng.normal(0, 0.05, base.shape)).astype(np.float32))
    cfg = Config().merge
    cfg.ransac_trials, cfg.icp_iters, cfg.pair_batch = 128, 8, 4
    preps = [recon.prep_view(p, 4.0, device="cpu") for p in clouds]
    pairs = [(preps[i + 1], preps[i]) for i in range(3)]
    seen = []
    step = reg._icp_step_update

    def spy(T, *args):
        seen.append(T.shape[0])
        return step(T, *args)

    monkeypatch.setattr(reg, "_icp_step_update", spy)
    group = recon.register_prep_pairs(pairs, [0, 1, 2], cfg, 4.0)
    for i in range(3):
        alone = recon.register_prep_pairs([pairs[i]], [i], cfg, 4.0)
        assert all(np.asarray(a[0]).tobytes() == np.asarray(g[i]).tobytes()
                   for a, g in zip(alone, group)), i
    assert seen and set(seen) == {cfg.pair_batch}


# ---------------------------------------------------------------------------
# coordinated runs (these four spawn worker processes)
# ---------------------------------------------------------------------------

def test_two_workers_byte_identical_to_single_process(dataset, baseline, tmp_path):
    out = str(tmp_path / "out")
    rep = _run(dataset, out, _setup(Config(), workers=2))
    c = rep.coordinator
    assert not rep.degraded and rep.views_computed == 0 and rep.views_cached == VIEWS
    _assert_parity(baseline, out)
    assert c["items_total"] == N_ITEMS and c["steals"] == 0 and c["device"] == "cpu"
    assert c["item_states"] == {"completed": N_ITEMS}
    assert set(c["completed_by_worker"]) <= {"w0", "w1"}
    assert c["worker_exit_codes"] == {"w0": 0, "w1": 0}
    replay = coordinator.Ledger.replay(os.path.join(out, "ledger.jsonl"))
    assert len(replay["completed"]) == N_ITEMS
    for r in (0, 1):
        spec = json.loads(open(os.path.join(out, ".coord", f"worker{r}.json")).read())
        assert spec["device"] == "cpu"
        log = open(os.path.join(out, ".coord", f"worker{r}.log")).read()
        assert "device cpu" in log and "exit: launches" in log


def test_worker_kill_on_the_fabric_with_incremental_assembly(dataset, baseline, tmp_path,
                                                             monkeypatch):
    """w0 dies (exit 137) on its first item; w1 takes everything. The pod
    fabric is on: each spawned worker warms a private L1 and pushes to the
    coordinator's blob store, the fold lane folds while w1 runs, and the
    journals of every process validate, their fabric bytes equal the blob
    server's counters."""
    monkeypatch.setenv("SL3D_FAULTS", "worker.item~w0:worker.kill")
    out = str(tmp_path / "out")
    cfg = _setup(Config(), workers=2)
    cfg.coordinator.listen = "127.0.0.1:0"
    cfg.coordinator.secret = "pod-secret"
    cfg.merge.incremental = True
    cfg.observability.trace = True
    rep = _run(dataset, out, cfg)
    c = rep.coordinator
    assert not rep.degraded
    _assert_parity(baseline, out)
    assert c["worker_exit_codes"]["w0"] == 137 and c["steals"] >= 1
    steals = [e for e in _events(out) if e["type"] == "steal"]
    assert steals and all(e["worker"] == "w0" for e in steals)
    assert c["item_states"] == {"completed": N_ITEMS}
    assert set(c["completed_by_worker"]) == {"w1"}
    assert os.path.isdir(os.path.join(out, ".slscan-cache.w1"))
    assert c["fabric"]["pushes"] >= N_ITEMS
    asm = c["assembly"]
    assert asm["enabled"] and asm["folded_views"] >= 1 and asm["tail_s"] > 0
    assert rep.assembly["used_views"] == asm["folded_views"]
    join = json.loads(open(os.path.join(out, ".coord", "join.json")).read())
    assert join["device"] == "cpu" and join["secret"] == "pod-secret"
    assert cli_main(["report", out, "--validate"]) == 0
    rows = replib.merge_host_timeline(out)
    moved = {k: sum(int(r.get(k) or 0) for r in rows if r.get("ev") == "fabric.bytes")
             for k in ("fetched", "pushed", "deduped")}
    fb = c["fabric"]
    assert (moved["fetched"], moved["pushed"], moved["deduped"]) == \
        (fb["bytes_fetched"], fb["bytes_pushed"], fb["bytes_deduped"])
    assert any(r["host"].startswith("w1-") for r in rows)


def test_coordinator_crash_then_resume_with_zero_recompute(dataset, baseline, tmp_path):
    out = str(tmp_path / "out")
    faults.configure("coord.grant:crash@3")
    with pytest.raises(faults.InjectedCrash):
        _run(dataset, out, _setup(Config(), workers=2))
    faults.reset()
    first = coordinator.Ledger.replay(os.path.join(out, "ledger.jsonl"))
    assert first["segments"] == 1 and len(first["completed"]) >= 1
    rep = _run(dataset, out, _setup(Config(), workers=2))
    assert not rep.degraded
    _assert_parity(baseline, out)
    c = rep.coordinator
    assert c["resumed_completed"] == len(first["completed"])
    assert c["items_total"] == N_ITEMS - len(first["completed"])
    second = _events(out)
    head = [i for i, e in enumerate(second) if e["type"] == "meta"][1]
    regranted = {e["item"] for e in second[head:] if e["type"] == "grant"}
    assert not regranted & first["completed"]
    assert len(coordinator.Ledger.replay(os.path.join(out, "ledger.jsonl"))
               ["completed"]) == N_ITEMS


def _views(cache_root, keys):
    out = []
    for k in keys:
        hit = StageCache(cache_root, log=lambda m: None).get("view", k)
        assert hit is not None
        out.append((np.asarray(hit["points"], np.float32),
                    np.asarray(hit["colors"], np.uint8)))
    return out


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


def test_numpy_backend_views_equal_the_jax_coordinated_run(dataset, tmp_path):
    calib = os.path.join(dataset, "calib.mat")
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    rep = _run(dataset, mine, _setup(Config(), workers=2, backend="numpy"))
    assert not rep.degraded and rep.coordinator["item_states"] == {"completed": N_ITEMS}
    # one JAX worker: a view's bytes do not depend on the worker count, and
    # each JAX worker pays its own registration compiles (~20 CPU-s)
    jcfg = _setup(JConfig(), workers=1, backend="numpy")
    jrep = jstages.run_pipeline(calib, dataset, theirs, cfg=jcfg, steps=STEPS,
                                log=lambda m: None)
    assert not jrep.degraded and jrep.coordinator["item_states"] == {
        "completed": N_ITEMS}
    pcfg = _setup(Config(), backend="numpy")
    _, _, keys, _ = stages._view_plan(
        calib, dataset, pcfg, STEPS, StageCache(os.path.join(mine, ".slscan-cache")),
        lambda m: None, torch.device("cpu"))
    _, _, _, jkeys = jstages._view_plan(
        calib, dataset, jcfg, STEPS, JStageCache(os.path.join(theirs, ".slscan-cache")),
        lambda m: None)
    assert len(keys) == len(jkeys) == VIEWS
    for i, (a, b) in enumerate(zip(_views(os.path.join(mine, ".slscan-cache"), keys),
                                   _views(os.path.join(theirs, ".slscan-cache"), jkeys))):
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes(), i
    merged = ply.read_ply(os.path.join(mine, "merged.ply"))["points"]
    jmerged = ply.read_ply(os.path.join(theirs, "merged.ply"))["points"]
    assert _chamfer(merged, jmerged) < 1.0
