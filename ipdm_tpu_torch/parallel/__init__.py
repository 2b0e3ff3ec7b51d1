"""Process-group parallelism: data-parallel training, view-sharded CT
physics and H-sharded UNet evaluation (port of ipdm_tpu/parallel)."""

from ipdm_tpu_torch.parallel.mesh import (gather_rows, make_mesh,
                                          make_sharded_train_step,
                                          make_spatial_sharded_apply,
                                          make_view_sharded_fbp,
                                          make_view_sharded_fp, shard_batch,
                                          shard_rows)
from ipdm_tpu_torch.parallel.spawn import run_ranks

__all__ = ["make_mesh", "shard_batch", "shard_rows", "gather_rows",
           "make_sharded_train_step", "make_spatial_sharded_apply",
           "make_view_sharded_fbp", "make_view_sharded_fp", "run_ranks"]
