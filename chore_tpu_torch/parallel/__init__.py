"""Data parallelism of the port over ``torch.distributed``."""
from chore_tpu_torch.parallel.mesh import (
    all_mean,
    init_distributed,
    is_main_process,
    local_batch_slice,
    process_count,
    process_index,
    shard_batch,
    sync_decision,
)

__all__ = [
    "all_mean",
    "init_distributed",
    "is_main_process",
    "local_batch_slice",
    "process_count",
    "process_index",
    "shard_batch",
    "sync_decision",
]
