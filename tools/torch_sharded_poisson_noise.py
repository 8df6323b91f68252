#!/usr/bin/env python3
"""How far the port's slab-sharded Poisson solve lies from the dense one, and
how far each lies from a float64 CG of the same discrete system, on the card.

    python3 tools/torch_sharded_poisson_noise.py

The input is ``chip_smoke.mesh_cloud()`` (188,067 points on the three
spheres' union), with normals estimated and oriented as ``mesh_cloud``
does. Printed, each as the max / p99 / mean of |chi_a - chi_b| (the p99 on
every 97th cell):
- depth 9, 350 CG steps: the dense solve against the sharded code on 1, 2
  and 4 slabs of one card (``devices=[cuda:0] * n``), and each against a
  float64 CG from the dense solve's own right-hand side and screen (so the
  f32 reduction order is the only difference between the f32 runs);
- depth 9, dense against 4 slabs after 50, 100 and 200 CG steps;
- depth 10, 350 steps, on 4, 2 and 1 slabs: wall, CG time, peak device
  memory, and the pairwise distances on chi[::16]^3 and chi[::4]^3.
Needs one card; about 2.5 minutes with the kernels' build.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.config import (  # noqa: E402
    MeshConfig,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import (  # noqa: E402
    normals as nrmlib,
)
from structured_light_for_3d_model_replication_tpu_torch.ops import poisson  # noqa: E402
from structured_light_for_3d_model_replication_tpu_torch.ops import (  # noqa: E402
    poisson_sharded as ps,
)


def f64_reference(pts, nr, depth: int, iters: int = 350, screen: float = 4.0):
    """``poisson._cg`` in float64 on the dense solve's b and screen."""
    f32 = torch.float32
    g = 1 << depth
    lo, hi = pts.amin(0), pts.amax(0)
    extent = (hi - lo).max() * (1.0 + 2.0 * torch.tensor(0.08, dtype=f32, device=pts.device))
    cell = extent / g
    coords = (pts - (0.5 * (lo + hi) - 0.5 * extent)) / cell - 0.5
    w = torch.ones((len(pts), 1), dtype=f32, device=pts.device)
    splat = poisson._trilinear_scatter((g, g, g), coords, torch.cat([nr * w, w], -1))
    density = splat[..., 3].double()
    b = -poisson._divergence(splat[..., :3]).double()
    del splat
    sw = screen * (density / density.max())
    return poisson._cg(lambda x: -poisson._laplacian(x) + sw * x, b, iters)


def dist(a, b) -> dict:
    d = (a.double() - b.double()).abs()
    return {"max": float(d.max()), "p99": float(torch.quantile(d.reshape(-1)[::97].float(), 0.99)),
            "mean": float(d.mean())}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cloud, _ = cs.mesh_cloud()
    m = MeshConfig()
    pts = torch.from_numpy(cloud).to(dev)
    v = torch.ones(len(cloud), dtype=torch.bool, device=dev)
    nr = nrmlib.orient_normals(pts, nrmlib.estimate_normals(
        pts, v, k=m.normal_max_nn, radius=m.normal_radius or None), v, mode="radial")
    out: dict = {}
    dense = poisson.poisson_solve(pts, nr, v, depth=9)
    out["chi9_absmax"] = float(dense.chi.abs().max())
    slabs = {n: ps.poisson_solve_sharded(pts, nr, v, depth=9, devices=[dev] * n)
             for n in (1, 2, 4)}
    ref = f64_reference(pts, nr, 9)
    for n, r in slabs.items():
        out[f"d9_dense_vs_{n}slab"] = dist(dense.chi, r.chi)
        out[f"d9_{n}slab_vs_f64"] = dist(r.chi, ref)
    out["d9_dense_vs_f64"] = dist(dense.chi, ref)
    out["d9_iso"] = [float(dense.iso)] + [float(slabs[n].iso) for n in (1, 2, 4)]
    del dense, slabs, ref
    for it in (50, 100, 200):
        out[f"d9_dense_vs_4slab_cg{it}"] = dist(
            poisson.poisson_solve(pts, nr, v, depth=9, cg_iters=it).chi,
            ps.poisson_solve_sharded(pts, nr, v, depth=9, devices=[dev] * 4,
                                     cg_iters=it).chi)
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    res = {}
    for n in (4, 2, 1):
        tm: dict = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = ps.poisson_solve_sharded(pts, nr, v, depth=10, devices=[dev] * n, timings=tm)
        torch.cuda.synchronize()
        res[n] = (r.chi[::16, ::16, ::16].clone(), r.chi[::4, ::4, ::4].clone(), float(r.iso))
        print(json.dumps({"depth": 10, "slabs": n, "wall_s": time.perf_counter() - t0,
                          "timings": tm, "cg_ms_per_step": 1e3 * tm["cg_s"] / 350,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "chi_absmax": float(r.chi.abs().max())}), flush=True)
        del r
        torch.cuda.empty_cache()
    print(json.dumps({f"d10_{a}v{b}_{s}": dist(res[a][i], res[b][i])
                      for a, b in ((4, 2), (4, 1), (2, 1)) for i, s in ((0, "sub16"), (1, "sub4"))}
                     | {"d10_iso": [res[n][2] for n in (4, 2, 1)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
