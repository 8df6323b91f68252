"""structured_light_for_3d_model_replication_tpu_torch — the PyTorch + CUDA port.

The same structured-light scan-to-print path as the JAX package beside it
(``structured_light_for_3d_model_replication_tpu``): reconstruct, clean,
merge, mesh, written for an NVIDIA Hopper GPU: plain tensor code is
PyTorch, and every Pallas kernel of the JAX package is a CUDA C++ kernel
for ``sm_90a`` (``ops/csrc/decode.cu``, ``ops/csrc/cloud.cu``).

This package imports ``torch`` and never ``jax``, and nothing from the JAX
package. Module names and layout follow the JAX package so a reader finds
each counterpart at the same path:

  config.py          the config dataclasses both paths read (same JSON)
  io/                PLY, STL, calibration .mat/.npz, frame stacks, .slbp codec
  calib/geometry.py  camera ray field + projector light planes (numpy)
  ops/graycode.py    pattern generation, Otsu thresholds, Gray decode
  ops/kernels.py     kernel wrappers, their plain versions, launch counts
  ops/triangulate.py ray-plane triangulation, compaction
  ops/knn.py         exact k-NN, radius counts, host cKDTree helpers
  ops/normals.py     PCA normals, orientation
  ops/pointcloud.py  voxel downsample, outlier masks, plane, clusters, clean chain
  ops/registration.py FPFH, RANSAC, point-to-plane ICP
  ops/poisson.py, ops/poisson_bricks.py, ops/surface_nets.py, ops/meshproc.py
                     screened Poisson (dense, brick-refined), iso-surface, mesh post-ops
  models/scanner.py  SLScanner (nn.Module): capture stack -> point cloud
  models/reconstruction.py merge_360: per-view clouds -> 360-degree cloud
  models/meshing.py  reconstruct_mesh: cloud -> watertight mesh, STL
  pipeline/stages.py reconstruct, clean, merge_views, mesh_cloud, run_pipeline
  cli.py             ``python -m structured_light_for_3d_model_replication_tpu_torch``

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
CUDA, ``device=None`` raises instead of running on the CPU.
"""

__version__ = "0.1.0"

from structured_light_for_3d_model_replication_tpu_torch.config import (  # noqa: F401
    Config,
    DecodeConfig,
    TriangulateConfig,
    load_config,
)
