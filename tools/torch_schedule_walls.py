#!/usr/bin/env python3
"""Cold walls of the port's ``run_pipeline`` schedule arms on the card.

    python3 tools/torch_schedule_walls.py [--reps 3] [--root DIR]

Renders ``chip_smoke.py``'s pipeline scene (24 views at 768x576, .slbp)
once, builds the kernels, then runs ``run_pipeline`` at ``chip_smoke``'s
pipeline config, each run in a fresh directory (cold: nothing cached), the
arms in turn so drift falls on all of them alike:

  streamed      the default: the register lane on its own CUDA stream
  barrier       ``merge.stream=false``
  shared        the streamed arm with the register lane on the main
                thread's stream (``_StreamRegistrar._on_stream`` replaced by
                a no-op), the counterfactual of the lane's own stream

One JSON line a run (host wall, the register lane's wall, the critical
path, the stage walls), then one line with each arm's median and spread,
and the card's name and power limit. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

ARMS = ("streamed", "barrier", "shared")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--root", default=None, help="work directory (default: a temp dir)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_schedule_walls: CUDA is not available", file=sys.stderr)
        return 2
    from structured_light_for_3d_model_replication_tpu_torch.config import load_config
    from structured_light_for_3d_model_replication_tpu_torch.ops import _build
    from structured_light_for_3d_model_replication_tpu_torch.pipeline import stages

    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="slscan_schedule_", dir=args.root) as root:
        data, calib, _ = chip_smoke.render_pipeline_views(root)
        # one untimed run: CUDA context, cuBLAS handles and the caching
        # allocator warm up once, for all arms
        stages.run_pipeline(calib, data, os.path.join(root, "warmup"),
                            cfg=load_config(None, chip_smoke.PIPE_OVERRIDES), device=dev,
                            log=lambda m: None)
        walls: dict[str, list[float]] = {a: [] for a in ARMS}
        for rep in range(args.reps):
            for arm in ARMS:
                over = dict(chip_smoke.PIPE_OVERRIDES)
                if arm == "barrier":
                    over["merge.stream"] = False
                shared = arm == "shared"
                saved = stages._StreamRegistrar._on_stream
                if shared:
                    stages._StreamRegistrar._on_stream = lambda self: contextlib.nullcontext()
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    report = stages.run_pipeline(
                        calib, data, os.path.join(root, f"{arm}_{rep}"),
                        cfg=load_config(None, over), device=dev, log=lambda m: None)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    stages._StreamRegistrar._on_stream = saved
                if report.failures:
                    print(f"torch_schedule_walls: {arm} run failed: "
                          f"{[f.as_dict() for f in report.failures]}", file=sys.stderr)
                    return 1
                walls[arm].append(wall)
                o = report.overlap or {}
                print(json.dumps({"arm": arm, "rep": rep, "wall_s": wall,
                                  "register_s": o.get("register_s"),
                                  "critical_path_s": o.get("critical_path_s"),
                                  "walls_s": report.walls_s, "card": card,
                                  "clocks": chip_smoke.clocks()}), flush=True)
        print(json.dumps({"summary": {a: {"median_s": float(np.median(w)),
                                          "min_s": min(w), "max_s": max(w), "runs": w}
                                      for a, w in walls.items()}, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
