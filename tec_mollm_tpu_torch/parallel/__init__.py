"""Data parallelism: one process per card, DistributedDataParallel over NCCL
(gloo on the CPU)."""

from tec_mollm_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    any_flag,
    barrier,
    broadcast_object,
    destroy,
    gather_rows,
    init_distributed,
    interleave_inverse,
    is_initialized,
    local_device,
    pad_batch_to_multiple,
    pad_batch_to_size,
    rank,
    world_size,
)

__all__ = [
    "all_reduce_sum",
    "any_flag",
    "barrier",
    "broadcast_object",
    "destroy",
    "gather_rows",
    "init_distributed",
    "interleave_inverse",
    "is_initialized",
    "local_device",
    "pad_batch_to_multiple",
    "pad_batch_to_size",
    "rank",
    "world_size",
]
