"""Multi-device meshes, and the host-level fault domains: the multiprocess
coordinator and the pod fabric.

  mesh.py         DeviceMesh, make_mesh / merge_mesh / views_mesh, the
                  shardings and the collectives (psum, pmax, pmin,
                  all_gather, ppermute, axis_index)
  scan.py         the sharded scan step (decode + triangulate + global stats)
  multihost.py    one torch.distributed group across processes, global_mesh

  netutil.py      endpoint grammar and worker tags (copied from the JAX package)
  lease.py        LeaseTable and LocalityIndex (copied from the JAX package)
  coordinator.py  the work ledger, the lease server, ``run_coordinated``
  worker.py       one worker process: ``python -m
                  structured_light_for_3d_model_replication_tpu_torch worker``
"""
