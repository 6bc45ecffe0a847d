"""Data and band-tensor parallelism on ``torch.distributed``."""
from ttsx_torch.parallel.data_parallel import (dp_synthesis, dp_train_step,
                                               make_dp_mesh, replicate,
                                               shard_batch_dp)

__all__ = ["make_dp_mesh", "shard_batch_dp", "replicate", "dp_synthesis",
           "dp_train_step"]
