"""The port's incremental assembly (``pipeline/assembly.py``) and
``finalize_chain(prefold=)`` on the CPU.

- The fold's arithmetic, for random clouds and random transforms: a view
  the fold lane moves (``assembly._move``, ``_apply_transforms`` on CPU
  tensors) equals ``transform_views_batched`` byte for byte, and so does
  ``finalize_chain`` seeded with a folded prefix (every prefix length) the
  unseeded one. The JAX package's numpy twin ``p @ R.T + t`` differs from
  these bytes on the same inputs (asserted, so the check has teeth: a fold
  in numpy's order would fail it).
- ``Prefold.validate`` gives the JAX package's verdicts (the trimmed
  length, or None) on the same order / digest / transform mismatches.
- The lane on a real run (the 5-view 96x72 synthetic scene of
  ``tests/test_coordinator.py``, torch engine on the CPU, the merged
  cloud's outlier pass off): a
  single-process run warms a stage cache; the fold lane, fed every
  settled item in a scrambled order, folds all 5 views and 4 pairs from
  it; the assembly pass over a copy of those view and pair entries then
  writes ``merged.ply`` and ``model.stl`` byte-identical to the
  single-process run with the full prefold (incremental), with a prefold
  trimmed by a wrong pair transform, and with none (barrier), each
  computing no view and no pair.
"""
import copy
import os
import shutil
import time

import numpy as np
import pytest
import torch

from structured_light_for_3d_model_replication_tpu.pipeline import assembly as jasm
from structured_light_for_3d_model_replication_tpu_torch.cli import main as cli_main
from structured_light_for_3d_model_replication_tpu_torch.config import Config
from structured_light_for_3d_model_replication_tpu_torch.models import (
    reconstruction as recon,
)
from structured_light_for_3d_model_replication_tpu_torch.pipeline import assembly, stages
from structured_light_for_3d_model_replication_tpu_torch.pipeline.stagecache import (
    StageCache,
)

VIEWS = 5
STEPS = ("statistical",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_transform(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = rng.uniform(-300, 300, size=3)
    return T


def test_the_fold_moves_views_with_finalize_chains_bytes():
    rng = np.random.default_rng(7)
    n = 5
    clouds = [(rng.uniform(-400, 400, size=(int(rng.integers(50, 3000)), 3))
               .astype(np.float32), rng.integers(0, 256, size=(1, 3), dtype=np.uint8))
              for _ in range(n)]
    clouds = [(p, np.repeat(c, len(p), 0)) for p, c in clouds]
    T_pairs = np.stack([_random_transform(rng) for _ in range(n - 1)])
    ones = np.ones(n - 1, np.float32)
    transforms = recon._chain(T_pairs, ones, ones, ones, lambda m: None)
    batched = recon.transform_views_batched([p for p, _ in clouds[1:]], transforms[1:],
                                            device="cpu")
    twin_differs = False
    for k in range(1, n):
        moved = assembly._move(clouds[k][0], transforms[k])
        assert moved.dtype == np.float32
        assert moved.tobytes() == batched[k - 1].tobytes(), f"view {k}"
        R, t = transforms[k][:3, :3], transforms[k][:3, 3]
        twin = (clouds[k][0] @ R.T + t).astype(np.float32)
        twin_differs |= twin.tobytes() != moved.tobytes()
    assert twin_differs, "these inputs do not tell the numpy twin's rounding apart"
    cfg = Config().merge
    cfg.final_voxel, cfg.outlier_nb = 0.0, 0
    ref = recon.finalize_chain(clouds, T_pairs, ones, ones, ones, cfg,
                               log=lambda m: None, device="cpu")
    for k in range(2, n + 1):
        pf = assembly.Prefold(transforms=transforms[:k],
                              merged_p=[clouds[0][0]] + [assembly._move(clouds[i][0],
                                                                       transforms[i])
                                                        for i in range(1, k)],
                              merged_c=[c for _, c in clouds[:k]],
                              T_pairs=list(T_pairs[:k - 1]))
        got = recon.finalize_chain(clouds, T_pairs, ones, ones, ones, cfg,
                                   log=lambda m: None, device="cpu", prefold=pf)
        assert got[0].tobytes() == ref[0].tobytes(), f"prefix {k}"
        assert got[1].tobytes() == ref[1].tobytes()
        assert all(np.array_equal(a, b) for a, b in zip(got[2], ref[2]))


_VALIDATE = {
    "whole": (lambda o, d, T: (o, d, T)),
    "quarantined-view": (lambda o, d, T: ([0, 1, 3, 4], d, T)),
    "digest-mismatch": (lambda o, d, T: (o, {**d, 2: "other"}, T)),
    "pair-mismatch": (lambda o, d, T: (o, d, [T[0], T[1] + 1e-3, T[2], T[3]])),
    "first-pair-mismatch": (lambda o, d, T: (o, d, [T[0] * 2] + T[1:])),
    "short-order": (lambda o, d, T: (o[:3], d, T)),
}


@pytest.mark.parametrize("case", sorted(_VALIDATE))
def test_prefold_validate_matches_the_jax_package(case):
    rng = np.random.default_rng(3)
    n = 5
    T_pairs = [_random_transform(rng) for _ in range(n - 1)]
    digests = {i: f"d{i}" for i in range(n)}
    fields = dict(digests=[digests[i] for i in range(n)],
                  transforms=[np.eye(4, dtype=np.float32)] * n,
                  merged_p=[np.zeros((2, 3), np.float32)] * n,
                  merged_c=[np.zeros((2, 3), np.uint8)] * n, T_pairs=list(T_pairs),
                  events=[("view", 0, 0.1)] + [e for i in range(1, n)
                                               for e in (("view", i, 0.1),
                                                         ("pair", i - 1, 0.2))],
                  settled_unix=5.0, offered_views=n)
    order, digs, Ts = _VALIDATE[case](list(range(n)), digests, T_pairs)
    mine = assembly.Prefold(**copy.deepcopy(fields)).validate(order, digs, Ts,
                                                              log=lambda m: None)
    theirs = jasm.Prefold(**copy.deepcopy(fields)).validate(order, digs, Ts,
                                                            log=lambda m: None)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert len(mine.transforms) == len(theirs.transforms)
        assert mine.events == theirs.events and mine.digests == theirs.digests
        assert len(mine.T_pairs) == len(theirs.T_pairs) == len(mine.transforms) - 1


# ---------------------------------------------------------------------------
# the fold lane over a real run's stage cache
# ---------------------------------------------------------------------------

def _cfg() -> Config:
    cfg = Config()
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
    return cfg


def _bytes(out, name):
    with open(os.path.join(out, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("asmds"))
    assert cli_main(["synth", root, "--views", str(VIEWS), "--cam", "96x72",
                     "--proj", "64x32"]) == 0
    out = str(tmp_path_factory.mktemp("asm_sp"))
    rep = stages.run_pipeline(os.path.join(root, "calib.mat"), root, out, cfg=_cfg(),
                              steps=STEPS, log=lambda m: None, device="cpu")
    assert not rep.degraded and rep.views_computed == VIEWS
    return root, out


def _seeded(single, dst) -> str:
    """A fresh out dir holding the single-process run's view and pair
    entries (no merge, no mesh entry)."""
    src = os.path.join(single[1], ".slscan-cache")
    os.makedirs(os.path.join(dst, ".slscan-cache"))
    for name in os.listdir(src):
        if name.startswith(("view-", "pair-")):
            shutil.copy(os.path.join(src, name), os.path.join(dst, ".slscan-cache", name))
    return str(dst)


def test_incremental_equals_barrier_equals_single_process(single, tmp_path):
    root, sp = single
    cfg = _cfg()
    dev = torch.device("cpu")
    calib = os.path.join(root, "calib.mat")
    cache = StageCache(os.path.join(sp, ".slscan-cache"), log=lambda m: None)
    _, sources, view_keys, _ = stages._view_plan(calib, root, cfg, STEPS, cache,
                                                 lambda m: None, dev)
    lane = assembly.IncrementalAssembler(cfg, view_keys, cache, dev, log=lambda m: None)
    # settle order scrambled: pairs before their views, views out of order
    for iid in ["pair:1", "view:2", "view:0", "pair:0", "view:1", "view:4", "pair:3",
                "pair:2", "view:3"]:
        lane.note_item(iid)
    lane.close()
    pf = lane.prefold(time.time())
    assert pf.offered_views == VIEWS and len(pf.T_pairs) == VIEWS - 1
    assert len(pf.events) == 2 * VIEWS - 1
    arms = {"incremental": pf, "barrier": None}
    bad = copy.deepcopy(pf)   # a wrong pair 2 -> 3: validate keeps views 0..2
    bad.T_pairs[2] = bad.T_pairs[2] + np.float32(1e-3)
    arms["trimmed"] = bad
    for arm, prefold in arms.items():
        out = _seeded(single, tmp_path / arm)
        rep = stages.run_pipeline(calib, root, out, cfg=cfg, steps=STEPS,
                                  log=lambda m: None, device="cpu", prefold=prefold)
        assert rep.views_computed == 0 and (rep.overlap or {}).get("pairs_dispatched",
                                                                   0) == 0, arm
        assert _bytes(out, "merged.ply") == _bytes(sp, "merged.ply"), arm
        assert _bytes(out, "model.stl") == _bytes(sp, "model.stl"), arm
        if prefold is None:
            assert rep.assembly is None
        else:
            used = {"incremental": VIEWS, "trimmed": 3}[arm]
            assert rep.assembly["used_views"] == used
            assert rep.assembly["folded_views"] == VIEWS and rep.assembly["tail_s"] > 0
            assert rep.overlap["assembly_folded_views"] == used
