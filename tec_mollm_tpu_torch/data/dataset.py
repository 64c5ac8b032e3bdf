"""Sliding-window view over a processed split, and the host batch pipeline.

Same contract as the JAX package's ``data/dataset.py``: window starts are
``range(0, T - L_in - L_out + 1, stride)``; item i is ``x = X[i : i+L_in]``,
``time_features = tf[i : i+L_in]`` and ``y = Y[i + L_in - 1]`` (Y holds the
L_out future steps of the window ending at t). Arrays are node-flattened:
X (T, N, C), Y (T, N, L_out), time_features (T, 4).

``BatchLoader`` yields numpy dicts exactly as the JAX loader does (shuffle by
``default_rng(seed + epoch)``, strided per-shard order, padding rows marked
``valid=False``, a prefetch thread); pinning and the copy to the card belong to
the caller (``training/trainer.py``). With ``index_only`` it yields the window
starts alone, in the same order and with the same padding, for the
device-resident archive (``data/device_data.py``).

While a ``torch.profiler`` is active, each batch's gather is a ``data.gather``
span (on the prefetch thread) and the consumer's wait on the prefetch queue a
``data.wait`` span (on its own thread): ``utils/profiler.py``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator

import numpy as np

from tec_mollm_tpu_torch.data import native_loader
from tec_mollm_tpu_torch.data.hdf5_io import valid_window_starts
from tec_mollm_tpu_torch.utils import profiler

logger = logging.getLogger(__name__)


class SlidingWindowDataset:
    """Windowed view over a processed split {X, Y, time_features[, segment_id]}."""

    def __init__(
        self,
        data: dict[str, np.ndarray],
        L_in: int,
        L_out: int,
        stride: int = 1,
        use_native: bool | None = None,
        tail_frac: float = 1.0,
    ):
        self.X = np.ascontiguousarray(data["X"], dtype=np.float32)
        self.Y = np.ascontiguousarray(data["Y"], dtype=np.float32)
        self.time_features = np.ascontiguousarray(data["time_features"], dtype=np.int32)
        if self.X.ndim != 3 or self.Y.ndim != 3:
            raise ValueError(
                f"Expect node-flattened X (T,N,C) / Y (T,N,L_out); got {self.X.shape} / "
                f"{self.Y.shape}. Use preprocess to flatten the grid."
            )
        self.L_in = L_in
        self.L_out = L_out
        # None: gather through native/tecloader.cpp when it builds here
        self.use_native = native_loader.available() if use_native is None else use_native
        max_start = len(self.X) - L_in - L_out + 1
        self.sample_indices = np.arange(0, max(max_start, 0), stride, dtype=np.int64)
        segment_id = data.get("segment_id")
        if segment_id is not None and len(self.sample_indices):
            before = len(self.sample_indices)
            self.sample_indices = valid_window_starts(
                self.sample_indices, np.asarray(segment_id), L_in, L_out
            )
            dropped = before - len(self.sample_indices)
            if dropped:
                logger.info(
                    "segment filter: dropped %d/%d windows spanning gaps", dropped, before
                )
        # tail_frac < 1 keeps the chronologically last fraction of the windows
        # (TrainConfig.val_tail_frac: under a solar-cycle shift the split's tail
        # is the closest proxy for the deployment epoch)
        if not 0.0 < tail_frac <= 1.0:
            raise ValueError(f"tail_frac must be in (0, 1], got {tail_frac}")
        if tail_frac < 1.0 and len(self.sample_indices):
            keep = max(1, int(np.ceil(tail_frac * len(self.sample_indices))))
            self.sample_indices = self.sample_indices[-keep:]

    @classmethod
    def from_dir(
        cls,
        data_dir: str,
        mode: str,
        L_in: int,
        L_out: int,
        stride: int = 1,
        tail_frac: float = 1.0,
    ) -> "SlidingWindowDataset":
        """Load ``{mode}_set.npz`` as written by the preprocess CLI."""
        with np.load(os.path.join(data_dir, f"{mode}_set.npz")) as d:
            data = {k: d[k] for k in ("X", "Y", "time_features")}
            if "segment_id" in d:
                data["segment_id"] = d["segment_id"]
        return cls(data, L_in=L_in, L_out=L_out, stride=stride, tail_frac=tail_frac)

    def __len__(self) -> int:
        return len(self.sample_indices)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        start = int(self.sample_indices[idx])
        return {
            "x": self.X[start : start + self.L_in],
            "y": self.Y[start + self.L_in - 1],
            "time_features": self.time_features[start : start + self.L_in],
        }

    def gather_batch(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        """Windows at dataset indices ``idxs``: x (B, L, N, C), y (B, N, L_out),
        time_features (B, L, 4); through the native gather when ``use_native``."""
        starts = self.sample_indices[idxs]
        if self.use_native:
            return native_loader.gather_windows(self.X, self.Y, self.time_features, starts, self.L_in)
        window = starts[:, None] + np.arange(self.L_in)[None, :]
        return {
            "x": self.X[window],
            "y": self.Y[starts + self.L_in - 1],
            "time_features": self.time_features[window],
        }


class BatchLoader:
    """Batches of a ``SlidingWindowDataset`` with optional shuffling, per-shard
    order and a prefetch thread, as numpy dicts with a ``valid`` (B,) mask.

    ``drop_remainder=True`` drops the last short batch; otherwise it is padded
    to full size with repeats of its last index, marked ``valid=False``."""

    def __init__(
        self,
        dataset: SlidingWindowDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        index_only: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        # index_only: yield {"starts": window starts} in place of the windows,
        # for the device-resident archive (data/device_data.py), which gathers
        # them on the card
        self.index_only = index_only
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose order the next iteration yields (a pure function of
        seed + epoch when shuffling)."""
        self.epoch = epoch

    def _epoch_indices(self) -> tuple[np.ndarray, int]:
        """(this shard's dataset indices, count of trailing padding entries:
        repeats appended so every shard has the same length)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        pad = 0
        if self.num_shards > 1:
            # strided, so the union of all shards' batch b is the rows one
            # process would put in its batch b
            shard = order[self.shard_index :: self.num_shards]
            if self.drop_remainder:
                shard = shard[: n // self.num_shards]
            else:
                # no window may be dropped: short shards repeat their last index
                # (an empty shard borrows one) so every shard has as many batches
                per_shard = -(-n // self.num_shards)
                pad = per_shard - len(shard)
                if pad:
                    fill = shard[-1:] if len(shard) else order[-1:]
                    shard = np.concatenate([shard, np.repeat(fill, pad)])
            order = shard
        return order, pad

    def __len__(self) -> int:
        n = len(self._epoch_indices()[0])
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _gather(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        if self.index_only:
            return {"starts": np.asarray(self.dataset.sample_indices[idxs], dtype=np.int32)}
        return self.dataset.gather_batch(idxs)

    def _batches(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        order, shard_pad = self._epoch_indices()
        valid_all = np.ones(len(order), dtype=bool)
        if shard_pad:
            valid_all[len(order) - shard_pad :] = False
        n_full = len(order) // self.batch_size
        for b in range(start_step, n_full):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            with profiler.span("data.gather"):
                batch = self._gather(order[sl])
            batch["valid"] = valid_all[sl].copy()
            yield batch
        rem = len(order) - n_full * self.batch_size
        if rem and not self.drop_remainder and start_step <= n_full:
            idxs = order[n_full * self.batch_size :]
            with profiler.span("data.gather"):
                batch = self._gather(np.concatenate([idxs, np.repeat(idxs[-1:], self.batch_size - rem)]))
            valid = np.zeros(self.batch_size, dtype=bool)
            valid[:rem] = valid_all[n_full * self.batch_size :]
            batch["valid"] = valid
            yield batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """This epoch's batches from batch index ``start_step`` on (a mid-epoch
        resume: the order is a pure function of seed + epoch, so skipping k
        batches continues where an interrupted run stopped; nothing is
        gathered for the skipped ones). With ``prefetch`` > 0 a thread gathers
        up to that many batches ahead; an error it raises is raised here."""
        if self.prefetch <= 0:
            yield from self._batches(start_step)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches(start_step):
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — handed to the consumer, which raises it
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, name="batch-prefetch", daemon=True)
        t.start()
        try:
            while True:
                with profiler.span("data.wait"):
                    item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            # a consumer that stops early (a mid-epoch stop) releases the thread
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
