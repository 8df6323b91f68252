"""Host-level fault domains: the multiprocess coordinator and the pod fabric.

  netutil.py      endpoint grammar and worker tags (copied from the JAX package)
  lease.py        LeaseTable and LocalityIndex (copied from the JAX package)
  coordinator.py  the work ledger, the lease server, ``run_coordinated``
  worker.py       one worker process: ``python -m
                  structured_light_for_3d_model_replication_tpu_torch worker``
"""
