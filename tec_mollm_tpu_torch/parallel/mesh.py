"""Data and tensor parallelism over ``torch.distributed``: one process per
card (``parallel/mesh.py`` of the JAX package, in PyTorch).

The JAX package builds a (data, model) device mesh and lets GSPMD insert the
collectives. Here each process drives one card: NCCL between cards, gloo on
the CPU. The process group comes from the environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
as ``jax.distributed`` reads its coordinator from the environment.

``init_distributed(model_parallel=mp)`` lays the ranks out as JAX's
``make_mesh`` lays out devices, the model axis innermost: rank ``r`` is data
rank ``r // mp`` and model rank ``r % mp``. The ``mp`` ranks of one data row
form a model group (the tensor-parallel collectives of
``parallel/tensor_parallel.py``); the ranks of one model rank form a data
group, over which DDP averages gradients and the loss, metric and
prediction reductions run (the ranks of a model group hold the same rows).
At ``mp = 1`` the data group is the world and there is no model group.
``barrier``, ``any_flag`` and ``broadcast_object`` always span the world.

Without an initialised group every helper is the single-process identity:
rank 0 of a world of 1, no collective.

``make_mesh``, ``batch_sharding``, ``replicated_sharding``, ``shard_batch`` and
``put_global`` have no counterpart: every rank builds the same seeded model
and slices its own part (``tensor_parallel.shard_model_``, in place of
``param_shardings``), DDP broadcasts the data group's first parameters when
it wraps the model, and each process's ``BatchLoader(num_shards=data_world(),
shard_index=data_rank())`` loads its own rows, which replaces placing a
global batch.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_local_device: torch.device | None = None
# the tensor-parallel degree and this rank's groups (None at mp 1: the data
# group is then the world, and no model group exists)
_model_parallel = 1
_data_group: Any = None
_model_group: Any = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def model_world() -> int:
    """The tensor-parallel degree: the ranks of one model group (1 without a group)."""
    return _model_parallel if is_initialized() else 1


def model_rank() -> int:
    return rank() % model_world()


def data_world() -> int:
    """The data-parallel degree: ``world_size() // model_world()``."""
    return world_size() // model_world()


def data_rank() -> int:
    return rank() // model_world()


def data_group() -> Any:
    """The ranks that share this rank's model rank (None: the world, at mp 1
    or without a group)."""
    return _data_group


def model_group() -> Any:
    """The ranks of this rank's data row (None at mp 1 or without a group)."""
    return _model_group


def local_device() -> torch.device | None:
    """The device ``init_distributed`` chose for this process, or None."""
    return _local_device


def init_distributed(
    backend: str | None = None,
    device: str | torch.device | None = None,
    model_parallel: int = 1,
    init_method: str | None = None,
) -> torch.device:
    """Join the process group, build the data and model groups of a
    ``data x model_parallel`` layout, and return this process's device.

    The rendezvous is ``init_method`` when given (for example
    ``file:///path``, a store no other group can take), with the rank and
    world from ``RANK`` and ``WORLD_SIZE``; else ``env://``, as ``torchrun``
    describes it (``MASTER_ADDR``, ``MASTER_PORT`` too).

    ``device`` None is the card ``LOCAL_RANK`` (which becomes the current
    CUDA device); ``"cpu"`` runs on the CPU. The backend defaults to NCCL on
    a card and gloo on the CPU. NCCL takes one process per card; gloo may put
    several on one card (a ``LOCAL_RANK`` past the host's cards wraps around),
    which is how a one-card machine runs two ranks. A world that is not a
    multiple of ``model_parallel`` raises JAX's ``make_mesh`` message. A
    second call returns the device of the first (and raises if it asks for
    another ``model_parallel``)."""
    global _local_device
    if is_initialized():
        if _local_device is None:
            raise RuntimeError("a process group exists that init_distributed did not make")
        if model_parallel != _model_parallel:
            raise RuntimeError(
                f"the process group was made with model_parallel={_model_parallel}, not {model_parallel}"
            )
        return _local_device
    needed = ("RANK", "WORLD_SIZE") if init_method else ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in needed if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group to join: {', '.join(missing)} unset (launch with torchrun, which sets them)"
        )
    check_model_parallel(int(os.environ["WORLD_SIZE"]), model_parallel)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --cpu (gloo) to run the ranks on the CPU")
        backend = backend or "nccl"
        if dev.index is None:
            count = torch.cuda.device_count()
            if local_rank >= count and backend == "nccl":
                raise RuntimeError(
                    f"LOCAL_RANK {local_rank} but this host has {count} card(s): NCCL takes one process a card"
                )
            dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
    if init_method:
        dist.init_process_group(backend=backend, init_method=init_method, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend=backend, init_method="env://")
    _local_device = dev
    _init_groups(model_parallel)
    return dev


def check_model_parallel(devices: int, model_parallel: int) -> None:
    """JAX's ``make_mesh`` refusal: ``devices`` (one process a card here)
    must be a multiple of ``model_parallel``."""
    if model_parallel < 1 or devices % model_parallel:
        raise ValueError(f"{devices} devices not divisible by model_parallel={model_parallel}")


def _init_groups(model_parallel: int) -> None:
    """Every rank makes every group (``new_group`` is collective), in one
    order: the model groups (data rows) first, then the data groups."""
    global _model_parallel, _data_group, _model_group
    _model_parallel = model_parallel
    if model_parallel == 1:
        return
    world, me = dist.get_world_size(), dist.get_rank()
    for d in range(world // model_parallel):
        ranks = list(range(d * model_parallel, (d + 1) * model_parallel))
        group = dist.new_group(ranks)
        if me in ranks:
            _model_group = group
    for m in range(model_parallel):
        ranks = list(range(m, world, model_parallel))
        group = dist.new_group(ranks)
        if me in ranks:
            _data_group = group


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _local_device, _model_parallel, _data_group, _model_group
    if is_initialized():
        dist.destroy_process_group()
    _local_device = None
    _model_parallel, _data_group, _model_group = 1, None, None


def _comm_device() -> torch.device:
    """Where a small host value travels: the card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return _local_device or torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "") -> None:
    """Every process waits here (a no-op at world 1). ``name`` documents the
    call site, as JAX's ``sync_global_devices`` names its barriers."""
    del name
    if world_size() > 1:
        dist.barrier()


def all_reduce_sum(tensor: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` (None: every process) in place and return
    it (unchanged without a process group)."""
    if is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every process (``obj`` itself at world 1)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_flag(flag: bool) -> bool:
    """True on every process when it is True on any: a signal delivered to
    one process stops them all at the same point (JAX's ``_sync_stop_flag``)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def max_over_ranks(value: float) -> float:
    """The largest ``value`` of every process (``value`` itself at world 1)."""
    if world_size() == 1:
        return float(value)
    t = torch.tensor([value], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def interleave_inverse(per_rank: int, world: int) -> np.ndarray:
    """The permutation that puts the ranks' stacked rows back in window order.

    ``BatchLoader(num_shards=world)`` gives rank p the windows
    ``order[p::world]``, so in the stack [rank 0's rows | rank 1's | ...] of
    one batch, row ``p * per_rank + i`` holds window ``i * world + p`` of the
    batch's block; indexing the stack by the result restores the block's
    order."""
    p = np.repeat(np.arange(world), per_rank)
    i = np.tile(np.arange(per_rank), world)
    return np.argsort(i * world + p, kind="stable")


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of one loader batch, on every process, in window
    order: ``all_gather`` of the same-shaped local tensors over the data
    group, then ``interleave_inverse``. ``t`` itself at a data world of 1."""
    world = data_world()
    if world == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src.contiguous(), group=data_group())
    stacked = torch.cat(parts)
    out = stacked[torch.as_tensor(interleave_inverse(t.shape[0], world), device=stacked.device)]
    return out.bool() if t.dtype == torch.bool else out


def pad_batch_to_size(batch: dict[str, Any], size: int) -> dict[str, Any]:
    """Pad the leading dim to exactly `size` rows (repeating the last row);
    padded rows get valid=False."""
    b = next(iter(batch.values())).shape[0]
    if b > size:
        raise ValueError(f"batch of {b} rows cannot pad down to {size}")
    if b == size:
        return batch
    pad = size - b
    out = {}
    for k, v in batch.items():
        pad_block = np.repeat(v[-1:], pad, axis=0)
        out[k] = np.concatenate([v, pad_block], axis=0)
    if "valid" in out:
        out["valid"][-pad:] = False
    else:
        valid = np.ones(size, dtype=bool)
        valid[-pad:] = False
        out["valid"] = valid
    return out


def pad_batch_to_multiple(batch: dict[str, Any], multiple: int) -> dict[str, Any]:
    """Pad the leading dim up to the next multiple; padded rows get valid=False."""
    b = next(iter(batch.values())).shape[0]
    return pad_batch_to_size(batch, -(-b // multiple) * multiple)
