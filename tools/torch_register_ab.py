#!/usr/bin/env python3
"""Registration walls of port trees side by side, on one CUDA card, in one call.

    python3 tools/torch_register_ab.py --trees PARENT . . PARENT [--out FILE]

Each ``--trees`` entry is the root of a checkout of the repo (a tree with
``chip_smoke.py`` and the port package). The scenes are made once, by the
first tree's ``chip_smoke``: phase 5's flagship merge scene (24 views,
reconstructed on the card into per-view PLYs) and phase 7's pipeline scene
(24 views, 768x576, .slbp). Then, for each entry in the order given, one
process with that tree first on ``sys.path`` runs, with the default
``Config()``:

- ``merge_views`` over the flagship PLYs twice (cold, then warm: the
  device arm of ``merge_360``) and once ``_merge_host_list`` (the
  host-list arm the streamed pipeline runs), each run's wall and
  ``register_s``;
- ``run_pipeline`` cold over the pipeline scene with phase 7's config in a
  fresh directory, its wall and the register lane's wall.

One JSON line per run goes to stdout and to ``--out``; the card's name and
power limit lead. Give the trees in the order parent, change, change,
parent so that drift on the card shows. Each process builds (or finds) its
tree's kernel library.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _child_env(tree: str) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def _prep(root: str) -> None:
    """Render both scenes and reconstruct the merge views (this tree)."""
    import chip_smoke as cs
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.ops import _build

    _build.build()
    dev = torch.device("cuda")
    data, calib, _ = cs.render_merge_views(root)
    ply_dir = cs.reconstruct_merge_views(dev, data, calib, os.path.join(root, "views"))
    pdata, pcalib, _ = cs.render_pipeline_views(os.path.join(root, "pipe"))
    with open(os.path.join(root, "scenes.json"), "w") as f:
        json.dump({"ply_dir": ply_dir, "data": pdata, "calib": pcalib}, f)


def _run(root: str, tag: str) -> None:
    """The measured runs of one tree (the one first on sys.path)."""
    import chip_smoke as cs
    import torch

    from structured_light_for_3d_model_replication_tpu_torch.config import (
        Config,
        load_config,
    )
    from structured_light_for_3d_model_replication_tpu_torch.models import (
        reconstruction as recon,
    )
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    _build.build()
    dev = torch.device("cuda")
    with open(os.path.join(root, "scenes.json")) as f:
        sc = json.load(f)
    work = tempfile.mkdtemp(prefix=f"ab_{tag}_", dir=root)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for arm in ("device_cold", "device_warm", "host_list"):
        tm: dict = {}
        if arm == "host_list":
            clouds = cs.read_clouds(sc["ply_dir"])
            wall = timed(lambda: recon._merge_host_list(clouds, Config().merge,
                                                        lambda m: None, tm, dev))
        else:
            wall = timed(lambda: stages.merge_views(
                sc["ply_dir"], os.path.join(work, f"{arm}.ply"), cfg=Config(),
                device=dev, timings=tm, log=lambda m: None))
        print(json.dumps({"tree": tag, "run": f"merge {arm}", "wall_s": wall,
                          "register_s": tm.get("register_s")}), flush=True)
    rep: list = []
    wall = timed(lambda: rep.append(stages.run_pipeline(
        sc["calib"], sc["data"], os.path.join(work, "pipeline"),
        cfg=load_config(None, cs.PIPE_OVERRIDES), device=dev, log=lambda m: None)))
    print(json.dumps({"tree": tag, "run": "pipeline cold", "wall_s": wall,
                      "register_s": (rep[0].overlap or {}).get("register_s"),
                      "pair_launches": (rep[0].overlap or {}).get("pair_launches")}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", choices=("prep", "run"), help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child == "prep":
        _prep(args.root)
        return 0
    if args.child == "run":
        _run(args.root, args.tag)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = [json.dumps({"card": card, "trees": trees})]
    print(lines[0], flush=True)
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="register_ab_") as root:
        steps = [("prep", trees[0], "prep")] + [
            ("run", t, f"{i}:{os.path.basename(t) or t}") for i, t in enumerate(trees)]
        for mode, tree, tag in steps:
            proc = subprocess.run(
                [sys.executable, me, "--trees", tree, "--child", mode, "--root", root,
                 "--tag", tag], cwd=tree, env=_child_env(tree), capture_output=True,
                text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            for line in proc.stdout.splitlines():
                if line.startswith('{"tree"'):
                    print(line, flush=True)
                    lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
