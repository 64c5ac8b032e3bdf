"""Checkpoints: the full train state for resume, and the best model's weights.

Files under ``<workdir>/checkpoints/<run_name>/``:

* ``latest.pt``: the trainable and frozen tensors, the optimizer's
  ``state_dict``, the step, the EMA (or None), the epoch and the step in it;
* ``latest.meta.json``: the trainer's metadata (the JAX ``_save_latest`` keys);
* ``best_params.pt``: a plain model ``state_dict``, which the eval, predict
  and serve CLIs load (``--checkpoint latest`` finds the newest through
  ``find_latest_checkpoint``).

Every write goes to a temporary file first and is renamed into place, so a
crash never leaves a half-written file under a checkpoint's name. The meta is
renamed before the state: ``has_checkpoint`` needs both, so the first save
never leaves a state without its meta; and the epoch and step in it are read
from the state file, so a crash between two renames of a later save cannot
resume a state at another position than its own. Dropout seeds derive from
(seed, step, microbatch), so the restored step also restores the random
stream: no generator state is saved.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from tec_mollm_tpu_torch.training.train_state import TrainState


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def capture_state(state: TrainState) -> dict[str, Any]:
    """The train state as a dict of tensors and numbers (references, not copies)."""
    return {
        "step": state.step,
        "trainable": {n: p.detach() for n, p in state.trainable().items()},
        "frozen": {n: p.detach() for n, p in state.frozen().items()},
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
    }


def load_state(state: TrainState, saved: Mapping[str, Any]) -> TrainState:
    """Copy a ``capture_state`` dict into ``state`` in place (each tensor keeps
    its device and dtype) and return it. Raises when the tensors do not match
    the model: another config than the checkpoint's, or EMA on one side only."""
    live = {"trainable": state.trainable(), "frozen": state.frozen()}
    for part, params in live.items():
        got = saved[part]
        if set(got) != set(params) or any(tuple(got[n].shape) != tuple(p.shape) for n, p in params.items()):
            raise RuntimeError(
                f"the checkpoint's {part} tensors do not match this model: check that the config matches "
                "the one the checkpoint was trained with (its config.json sits beside it)"
            )
    if (saved["ema"] is None) != (state.ema is None):
        raise RuntimeError(
            "the checkpoint and this run disagree on the EMA: resume with the --ema-decay "
            "on/off state the checkpoint was trained with"
        )
    with torch.no_grad():
        for part, params in live.items():
            for n, p in params.items():
                p.copy_(saved[part][n])
        if state.ema is not None:
            for n, e in state.ema.items():
                e.copy_(saved["ema"][n])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


class CheckpointManager:
    """Save and restore under ``<workdir>/checkpoints/<run_name>/``."""

    def __init__(self, workdir: str, run_name: str):
        self.dir = os.path.abspath(os.path.join(workdir, "checkpoints", run_name))
        os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".pt")

    def save_state(self, state: TrainState, meta: dict[str, Any], name: str = "latest") -> str:
        """``<name>.pt`` (the train state, with meta's epoch and step_in_epoch)
        and ``<name>.meta.json``."""
        path = self.path(name)
        blob = capture_state(state)
        blob.update(epoch=meta["epoch"], step_in_epoch=meta["step_in_epoch"])
        meta_tmp = os.path.join(self.dir, name + ".meta.json.tmp")
        with open(meta_tmp, "w") as f:
            json.dump(meta, f)
        torch.save(blob, path + ".tmp")
        os.replace(meta_tmp, os.path.join(self.dir, name + ".meta.json"))
        os.replace(path + ".tmp", path)
        return path

    def restore_state(self, state: TrainState, name: str = "latest") -> tuple[TrainState, dict[str, Any]]:
        """Load ``<name>.pt`` into ``state`` in place; returns (state, meta)."""
        saved = torch.load(self.path(name), map_location="cpu", weights_only=True)
        with open(os.path.join(self.dir, name + ".meta.json")) as f:
            meta = json.load(f)
        meta.update(epoch=saved["epoch"], step_in_epoch=saved["step_in_epoch"])
        return load_state(state, saved), meta

    def has_checkpoint(self, name: str = "latest") -> bool:
        return os.path.exists(self.path(name)) and os.path.exists(os.path.join(self.dir, name + ".meta.json"))

    def save_params(self, state_dict: Mapping[str, torch.Tensor], name: str = "best") -> str:
        """``<name>_params.pt``: a model state_dict, saved as it is given."""
        path = self.path(name + "_params")
        _atomic_save(dict(state_dict), path)
        return path



def find_latest_checkpoint(
    checkpoint_root: str, kind: str = "best_params.pt", run_name: str | None = None
) -> str:
    """The most recently modified ``<run>/<kind>`` file under
    ``checkpoint_root`` (the JAX package's ``find_latest_checkpoint``, whose
    checkpoints are directories). ``run_name`` restricts the search to one
    run: without it, a workdir of several configs resolves to whichever run
    saved last. Raises ``FileNotFoundError`` when there is none."""
    runs = [run_name] if run_name else sorted(os.listdir(checkpoint_root))
    candidates = [
        path for path in (os.path.join(checkpoint_root, run, kind) for run in runs) if os.path.isfile(path)
    ]
    if not candidates:
        where = f"{checkpoint_root}/{run_name}" if run_name else checkpoint_root
        raise FileNotFoundError(f"No '{kind}' checkpoints under {where}")
    return max(candidates, key=os.path.getmtime)
