"""Device-resident archive: a split's raw series lives on the card, and windows
are gathered there by index instead of streamed from the host.

The JAX package's ``data/device_data.py`` in PyTorch. The materialized
sliding-window split is ~48x redundant: every timestep appears in L_in windows,
and the five space-weather indices are broadcast to all N nodes. The
de-duplicated raw form that the preprocess CLI writes as ``{split}_raw.npz``,

    TEC (T_raw, N) float32  +  indices (T_raw, 5)  +  time features (T_x, 4),

is small enough to stay in device memory for the whole archive. Batches are
then index-driven: ``BatchLoader(index_only=True)`` yields only the window
starts and the validity mask (a few hundred bytes a step), and
``DeviceSplit.gather`` rebuilds the exact (B, L, N, 6) / (B, N, L_out) arrays
the host pipeline would have copied, with tensor indexing on the device (JAX's
``jnp.take``; it is XLA code there, not a Pallas kernel).

Numbers: the preprocess CLI scales X and Y with fp32 affines
``(raw - mean_f32) * (1/scale)_f32`` (``StandardScaler._affine``); the gather
applies the same fp32 constants in the same order, so a gathered fp32 batch
equals the ``{split}_set.npz`` windows bit for bit.

Used by ``python -m tec_mollm_tpu_torch.train --device-data``
(``TrainConfig.device_data``) and by evaluation with a config that sets it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from tec_mollm_tpu_torch.data.hdf5_io import valid_window_starts
from tec_mollm_tpu_torch.data.scaler import StandardScaler


@dataclasses.dataclass(frozen=True)
class DeviceSplit:
    """The on-device half: the raw series and the scalers' constants as tensors
    on one device, and the window gather."""

    tec: torch.Tensor         # (T_raw, N) f32, raw physical TEC
    sw: torch.Tensor          # (T_raw, 5) f32, raw space-weather indices
    tf: torch.Tensor          # (T_x, 4) int32, time features (already truncated)
    feat_shift: torch.Tensor  # (6,) f32, the feature scaler's mean
    feat_mul: torch.Tensor    # (6,) f32, 1/scale inverted in f64 then cast
    tgt_shift: torch.Tensor   # () f32, the target scaler's mean
    tgt_mul: torch.Tensor     # () f32
    L_in: int
    L_out: int
    compute_dtype: torch.dtype = torch.float32

    def gather(self, starts: torch.Tensor, valid: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """starts (B,) window-start indices on the device -> the batch the host
        pipeline would have assembled: x (B, L_in, N, 6) in compute_dtype,
        y (B, N, L_out) f32, time_features (B, L_in, 4) int32 (and ``valid``
        when given)."""
        L, H = self.L_in, self.L_out
        starts = starts.long()
        b, n = starts.shape[0], self.tec.shape[1]
        win = starts[:, None] + torch.arange(L, device=starts.device)                 # (B, L)
        x0 = (self.tec[win] - self.feat_shift[0]) * self.feat_mul[0]                  # (B, L, N)
        sw_w = (self.sw[win] - self.feat_shift[1:]) * self.feat_mul[1:]               # (B, L, 5)
        x = torch.cat([x0[..., None], sw_w[:, :, None, :].expand(b, L, n, 5)], dim=-1).to(self.compute_dtype)
        # y[b, n, h] = scaled TEC[start + L_in + h, n]: the target identity
        # Y[t][h] == tec[t + 1 + h] at t = start + L_in - 1
        tgt = starts[:, None] + L + torch.arange(H, device=starts.device)            # (B, H)
        y = (self.tec[tgt] - self.tgt_shift) * self.tgt_mul                           # (B, H, N)
        batch = {"x": x, "y": y.transpose(1, 2).contiguous(), "time_features": self.tf[win]}
        if valid is not None:
            batch["valid"] = valid
        return batch


class DeviceResidentDataset:
    """The host half: loads ``{mode}_raw.npz``, the time features and the
    scalers, owns the window index space (``sample_indices`` with the
    semantics of ``SlidingWindowDataset``: stride, the segment filter,
    ``tail_frac``), and builds the device half or host batches on demand."""

    def __init__(
        self,
        data_dir: str,
        mode: str,
        L_in: int,
        L_out: int,
        stride: int = 1,
        tail_frac: float = 1.0,
    ):
        raw_path = os.path.join(data_dir, f"{mode}_raw.npz")
        if not os.path.exists(raw_path):
            raise FileNotFoundError(
                f"{raw_path} not found — the device-resident path needs the "
                "de-duplicated raw series written by the preprocess CLI "
                "(re-run `python -m tec_mollm_tpu_torch.data.preprocess`; "
                "archives predating the *_raw.npz export only support the host pipeline)"
            )
        with np.load(raw_path) as d:
            self.tec = np.ascontiguousarray(d["tec"], dtype=np.float32)
            self.sw = np.ascontiguousarray(d["sw"], dtype=np.float32)
            self.segment_id = np.asarray(d["segment_id"]) if "segment_id" in d else None
        # time features: small, already truncated to len(X) = T_raw - horizon
        with np.load(os.path.join(data_dir, f"{mode}_set.npz")) as d:
            self.tf = np.ascontiguousarray(d["time_features"], dtype=np.int32)
        with open(os.path.join(data_dir, "preprocess_meta.json")) as f:
            self.horizon = int(json.load(f)["horizon"])
        if L_out > self.horizon:
            raise ValueError(f"L_out={L_out} exceeds the archive horizon {self.horizon}")
        feat = StandardScaler.load(os.path.join(data_dir, "scaler.npz"))
        tgt = StandardScaler.load(os.path.join(data_dir, "target_scaler.npz"))
        # StandardScaler._affine's constants: the mean cast to f32, 1/scale
        # computed in f64 and then cast
        self.feat_shift = feat.mean_.astype(np.float32)
        self.feat_mul = (1.0 / feat.scale_).astype(np.float32)
        self.tgt_shift = np.float32(tgt.mean_[0])
        self.tgt_mul = np.float32(1.0 / tgt.scale_[0])

        self.L_in = L_in
        self.L_out = L_out
        self.stride = stride
        # SlidingWindowDataset's window starts over the truncated X
        # (len = T_raw - horizon): max_start = len(X) - L_in - L_out + 1
        max_start = self.tec.shape[0] - self.horizon - L_in - L_out + 1
        self.sample_indices = np.arange(0, max(max_start, 0), stride, dtype=np.int64)
        if self.segment_id is not None and len(self.sample_indices):
            # the gather indexes raw positions: a window spanning an archive
            # discontinuity must never enter the index space
            self.sample_indices = valid_window_starts(self.sample_indices, self.segment_id, L_in, L_out)
        if not 0.0 < tail_frac <= 1.0:
            raise ValueError(f"tail_frac must be in (0, 1], got {tail_frac}")
        if tail_frac < 1.0 and len(self.sample_indices):
            keep = max(1, int(np.ceil(tail_frac * len(self.sample_indices))))
            self.sample_indices = self.sample_indices[-keep:]

    def __len__(self) -> int:
        return len(self.sample_indices)

    def nbytes(self) -> int:
        """Device bytes of the resident arrays."""
        return self.tec.nbytes + self.sw.nbytes + self.tf.nbytes

    def device_split(self, device: torch.device | str, compute_dtype: torch.dtype = torch.float32) -> DeviceSplit:
        """The arrays on ``device``; x of a gathered batch in ``compute_dtype``."""

        def put(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a)).to(device)

        return DeviceSplit(
            tec=put(self.tec), sw=put(self.sw), tf=put(self.tf),
            feat_shift=put(self.feat_shift), feat_mul=put(self.feat_mul),
            tgt_shift=put(self.tgt_shift), tgt_mul=put(self.tgt_mul),
            L_in=self.L_in, L_out=self.L_out, compute_dtype=compute_dtype,
        )

    def gather_batch(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        """The host mirror of ``DeviceSplit.gather`` for dataset indices
        ``idxs`` (numpy, fp32): what the HA baseline, a service and the parity
        tests read; the training path never calls it."""
        starts = self.sample_indices[idxs]
        L, H = self.L_in, self.L_out
        win = starts[:, None] + np.arange(L)
        x0 = (self.tec[win] - self.feat_shift[0]) * self.feat_mul[0]
        sw_w = (self.sw[win] - self.feat_shift[1:]) * self.feat_mul[1:]
        b, n = len(starts), self.tec.shape[1]
        x = np.concatenate(
            [x0[..., None], np.broadcast_to(sw_w[:, :, None, :], (b, L, n, 5))], axis=-1, dtype=np.float32,
        )
        tgt = starts[:, None] + L + np.arange(H)
        y = (self.tec[tgt] - self.tgt_shift) * self.tgt_mul
        return {
            "x": x,
            "y": np.ascontiguousarray(y.transpose(0, 2, 1), dtype=np.float32),
            "time_features": self.tf[win],
        }
