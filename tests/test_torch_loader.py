"""PyTorch port: the host data pipeline and the streaming metrics against the
JAX package's.

The port's BatchLoader must yield the JAX loader's numpy batches bit for bit
(same order, padding and valid masks), the native window gather must equal
numpy's gather bit for bit, ``tail_frac`` must keep the same windows, and the
streaming validation metrics must finalize to the JAX values within rtol 1e-6
(both sum fp32 per-batch statistics; the port adds them up in float64 on the
device, JAX in fp32 chunks then float64 on the host)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.data.dataset import BatchLoader as JaxBatchLoader
from tec_mollm_tpu.data.dataset import SlidingWindowDataset as JaxDataset
from tec_mollm_tpu.data.scaler import StandardScaler as JaxScaler
from tec_mollm_tpu.data.synthetic import synthetic_processed_split
from tec_mollm_tpu.evaluation.streaming import StreamingHorizonMetrics as JaxStreaming
from tec_mollm_tpu_torch.data import BatchLoader, SlidingWindowDataset, StandardScaler, native_loader
from tec_mollm_tpu_torch.evaluation.streaming import StreamingHorizonMetrics
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L_IN, L_OUT, NODES = 6, 3, 5


@pytest.fixture(scope="module")
def split():
    return synthetic_processed_split(num_windows=23, L_in=L_IN, L_out=L_OUT, num_nodes=NODES, seed=4)


def _pair(split, stride=1, tail_frac=1.0, use_native=False):
    return (
        JaxDataset(split, L_IN, L_OUT, stride=stride, use_native=False, tail_frac=tail_frac),
        SlidingWindowDataset(split, L_IN, L_OUT, stride=stride, use_native=use_native, tail_frac=tail_frac),
    )


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class TestBatchLoader:
    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("shards", [1, 3])
    @pytest.mark.parametrize("drop_remainder", [False, True])
    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_every_shard_equals_jax(self, split, shuffle, shards, drop_remainder, prefetch):
        jds, pds = _pair(split, stride=2 if shards == 3 else 1)
        for shard in range(shards):
            kw = dict(batch_size=4, shuffle=shuffle, seed=7, drop_remainder=drop_remainder,
                      num_shards=shards, shard_index=shard, prefetch=prefetch)
            jl, pl = JaxBatchLoader(jds, **kw), BatchLoader(pds, **kw)
            for epoch in (0, 3):
                jl.set_epoch(epoch)
                pl.set_epoch(epoch)
                assert len(pl) == len(jl)
                want = list(jl)
                _same_batches(list(pl), want)
                for k in (0, 2, len(want), len(want) + 1):
                    _same_batches(list(pl.iter_from(k)), list(jl.iter_from(k)))

    def test_valid_marks_the_padding(self, split):
        _, pds = _pair(split)
        batches = list(BatchLoader(pds, batch_size=4, drop_remainder=False))
        assert [int(b["valid"].sum()) for b in batches] == [4] * 5 + [3]
        assert not batches[-1]["valid"][-1]
        np.testing.assert_array_equal(batches[-1]["x"][-1], batches[-1]["x"][-2])  # a repeat

    def test_epochs_reshuffle(self, split):
        _, pds = _pair(split)
        loader = BatchLoader(pds, batch_size=1, shuffle=True, seed=1)
        first = np.concatenate([b["y"] for b in loader])
        loader.set_epoch(1)
        second = np.concatenate([b["y"] for b in loader])
        assert not np.array_equal(first, second)
        np.testing.assert_array_equal(np.sort(first.ravel()), np.sort(second.ravel()))

    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_producer_error_reaches_the_consumer(self, split, prefetch):
        _, pds = _pair(split)
        calls = {"n": 0}
        real = pds.gather_batch

        def failing(idxs):
            calls["n"] += 1
            if calls["n"] == 3:
                raise OSError("disk gone")
            return real(idxs)

        pds.gather_batch = failing
        loader = BatchLoader(pds, batch_size=4, prefetch=prefetch)
        got = []
        with pytest.raises(OSError, match="disk gone"):
            for b in loader:
                got.append(b)
        assert len(got) == 2

    def test_a_consumer_that_stops_early_releases_the_thread(self, split):
        _, pds = _pair(split)
        before = threading.active_count()
        it = BatchLoader(pds, batch_size=2, prefetch=1).iter_from(0)
        next(it)
        it.close()
        assert threading.active_count() == before


class TestDataset:
    @pytest.mark.parametrize("tail_frac", [1.0, 0.3, 0.05])
    @pytest.mark.parametrize("stride", [1, 3])
    def test_tail_frac_keeps_jax_windows(self, split, tail_frac, stride):
        jds, pds = _pair(split, stride=stride, tail_frac=tail_frac)
        np.testing.assert_array_equal(pds.sample_indices, jds.sample_indices)
        for i in (0, len(pds) - 1):
            for k, v in jds[i].items():
                np.testing.assert_array_equal(pds[i][k], v)

    def test_tail_frac_out_of_range_is_refused(self, split):
        with pytest.raises(ValueError, match="tail_frac"):
            SlidingWindowDataset(split, L_IN, L_OUT, tail_frac=0.0)


class TestNativeGather:
    def test_builds_here(self):
        assert native_loader.available()
        assert native_loader.BUILD_ROOT in native_loader._build().parents

    @pytest.mark.parametrize("idxs", [[0], [3, 1, 22, 22, 7], list(range(23))])
    def test_equals_numpy_bit_for_bit(self, split, idxs):
        native = SlidingWindowDataset(split, L_IN, L_OUT, use_native=True)
        plain = SlidingWindowDataset(split, L_IN, L_OUT, use_native=False)
        got, want = native.gather_batch(np.asarray(idxs)), plain.gather_batch(np.asarray(idxs))
        for k, v in want.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    def test_refuses_what_it_would_misread(self, split):
        x = np.asarray(split["X"])
        with pytest.raises(ValueError, match="C-contiguous"):
            native_loader.gather_windows(x[:, ::-1], split["Y"], split["time_features"], np.array([0]), L_IN)
        with pytest.raises(ValueError, match="window starts"):
            native_loader.gather_windows(x, split["Y"], split["time_features"], np.array([len(x)]), L_IN)


class TestStreamingMetrics:
    @pytest.mark.parametrize("scaled", [True, False])
    def test_finalize_matches_jax(self, scaled):
        rng = np.random.default_rng(0)
        mean, scale = np.array([25.0]), np.array([12.0])
        jacc = JaxStreaming(L_OUT, JaxScaler(mean, scale) if scaled else None)
        pacc = StreamingHorizonMetrics(L_OUT, StandardScaler(mean, scale) if scaled else None)
        for b in range(4):
            trues = rng.normal(size=(3, L_OUT, 40, 1)).astype(np.float32)
            preds = (trues + 0.5 * rng.normal(size=trues.shape)).astype(np.float32)
            preds[0, 0, :3, 0] = [np.nan, np.inf, -30.0]  # guards and the physical clip
            valid = np.array([True, b != 2, b != 3])
            jacc.update(jnp.asarray(trues), jnp.asarray(preds), jnp.asarray(valid))
            pacc.update(torch.from_numpy(trues), torch.from_numpy(preds), torch.from_numpy(valid))
        want, got = jacc.finalize(), pacc.finalize()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9, err_msg=k)
            assert isinstance(got[k], type(v))
