from .mesh import (
    all_reduce_mean,
    all_reduce_sum,
    init_data_parallel,
    prompt_block,
    replicate,
    shard_batch,
    shard_rows,
)

__all__ = ["all_reduce_mean", "all_reduce_sum", "init_data_parallel", "prompt_block", "replicate",
           "shard_batch", "shard_rows"]
