"""PyTorch port: the data-parallel helpers (``parallel/mesh.py``) in one
process.

The batch padding against the JAX package's on the same numpy batch
(identical arrays); the inverse of the ranks' strided interleave against the
JAX package's ``argsort`` formula and against ``BatchLoader``'s own shards at
worlds 2 and 3; every helper at world 1 with no process group; the dropout
seed of rank 0 unchanged. Two real ranks are tests/test_torch_ddp.py."""

import numpy as np
import pytest
import torch

import tec_mollm_tpu.parallel.mesh as jmesh
from tec_mollm_tpu_torch import parallel
from tec_mollm_tpu_torch.data.dataset import BatchLoader
from tec_mollm_tpu_torch.training.train_state import dropout_seed


def _batch(rng, b, valid=True):
    out = {"x": rng.standard_normal((b, 3, 2)).astype(np.float32), "t": rng.integers(0, 9, (b, 4)).astype(np.int32)}
    if valid:
        out["valid"] = rng.random(b) > 0.3
    return out


@pytest.mark.parametrize("b, size, valid", [(5, 8, True), (5, 8, False), (8, 8, True), (1, 4, False)])
def test_pad_batch_to_size_is_the_jax_one(b, size, valid):
    rng = np.random.default_rng(b * 10 + size)
    batch = _batch(rng, b, valid)
    got = parallel.pad_batch_to_size({k: v.copy() for k, v in batch.items()}, size)
    want = jmesh.pad_batch_to_size({k: v.copy() for k, v in batch.items()}, size)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("b, multiple", [(5, 4), (8, 4), (7, 3), (1, 2)])
def test_pad_batch_to_multiple_is_the_jax_one(b, multiple):
    batch = _batch(np.random.default_rng(b), b)
    got = parallel.pad_batch_to_multiple({k: v.copy() for k, v in batch.items()}, multiple)
    want = jmesh.pad_batch_to_multiple({k: v.copy() for k, v in batch.items()}, multiple)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pad_refuses_to_shrink():
    with pytest.raises(ValueError, match="cannot pad down"):
        parallel.pad_batch_to_size(_batch(np.random.default_rng(0), 5), 4)


@pytest.mark.parametrize("world, per", [(2, 1), (2, 3), (3, 2), (3, 4)])
def test_interleave_inverse_is_the_jax_formula(world, per):
    """tec_mollm_tpu/evaluation/harness.py:get_model_predictions' inverse."""
    p = np.repeat(np.arange(world), per)
    i = np.tile(np.arange(per), world)
    np.testing.assert_array_equal(parallel.interleave_inverse(per, world), np.argsort(i * world + p, kind="stable"))


class _Windows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def gather_batch(self, idx):
        return {"w": np.asarray(idx)}


@pytest.mark.parametrize("world, n, per", [(2, 9, 2), (3, 10, 2), (3, 7, 1)])
def test_stacked_shards_in_window_order(world, n, per):
    """The ranks' loader batches, stacked and reordered, are one process's
    batches of world * per windows; after dropping the padding, every window
    once, in order."""
    loaders = [BatchLoader(_Windows(n), batch_size=per, drop_remainder=False, num_shards=world, shard_index=r)
               for r in range(world)]
    whole = list(BatchLoader(_Windows(n), batch_size=world * per, drop_remainder=False))
    seen = []
    for b, parts in enumerate(zip(*loaders)):
        rows = np.concatenate([p["w"] for p in parts])[parallel.interleave_inverse(per, world)]
        valid = np.concatenate([p["valid"] for p in parts])[parallel.interleave_inverse(per, world)]
        np.testing.assert_array_equal(rows[valid], whole[b]["w"][whole[b]["valid"]])
        seen.extend(rows[valid].tolist())
    assert seen == list(range(n))


def test_helpers_at_world_1_without_a_group():
    assert not parallel.is_initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.local_device()) == (0, 1, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert parallel.gather_rows(t) is t
    assert parallel.all_reduce_sum(t) is t and torch.equal(t, torch.arange(6.0).reshape(3, 2))
    assert parallel.any_flag(True) and not parallel.any_flag(False)
    assert parallel.broadcast_object({"a": 1}) == {"a": 1}
    parallel.barrier("no-op")
    parallel.destroy()  # no group: nothing to leave


def test_init_distributed_names_what_torchrun_would_set(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT unset"):
        parallel.init_distributed(device="cpu")


def test_dropout_seed_of_rank_0_is_the_single_process_one():
    ss = np.random.SeedSequence([7, 3, 1]).generate_state(1, np.uint64)[0] >> 1
    assert dropout_seed(7, 3, 1) == dropout_seed(7, 3, 1, rank=0) == int(ss)
    assert len({dropout_seed(7, 3, 1, rank=r) for r in range(4)}) == 4
