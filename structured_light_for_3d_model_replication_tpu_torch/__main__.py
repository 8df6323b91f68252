import sys

from structured_light_for_3d_model_replication_tpu_torch.cli import main

sys.exit(main())
