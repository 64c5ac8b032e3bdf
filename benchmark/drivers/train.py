"""The train CLI's loop: ``Trainer.train_epoch(checkpoints=False)`` epoch after
epoch, without validation or saves.

Set-up builds one ``Trainer`` on a seeded train split, gives it the seeded
weights (``set_params``) and drives its first ``CHECK_STEPS`` macro steps
through ``train_epoch`` one step a call (the same loader feeds them, through
``_Steps``, which stops the loader after one batch and notes which windows the
batch holds), recording the keep mask of every dropout site the step applies
(``benchmark.masks``), reading after step 1 the gradient AdamW received (its
first moment over 1 - b1) and after the last the trainable tensors' change;
then it finishes epoch 0 as the warm-up. The window
runs whole epochs until ``seconds`` have passed, so it ends at an epoch's end:
``train_windows_per_s`` is every window trained over the window's whole time.

The check: the reference follows the same first steps from the same weights,
rows and dropout masks, in float32; compared are each step's loss, the first
gradient leaf by leaf, and each leaf's change after the last step. The rows
are read from the batches the loader handed over (each found in the split by
its content and checked whole) and the masks from where the program applied
them, so the reference depends neither on the loader's shuffle nor on how the
program draws its masks. On several ranks, rank 0 gathers every rank's rows
and masks and runs the reference.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from benchmark import masks as masks_lib
from benchmark import trace as trace_lib
from benchmark import traffic as traffic_lib
from benchmark.drivers import common
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

CHECK_STEPS = 3
BETA1 = 0.9


class _Steps:
    """The trainer's loader, yielding one batch of each ``iter_from`` and
    noting its rows (``rows_of``) in ``rows``."""

    def __init__(self, loader, data: dict, l_in: int):
        self.loader, self.data, self.l_in = loader, data, l_in
        self.rows: list[np.ndarray] = []

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def iter_from(self, start_step: int = 0):
        it = self.loader.iter_from(start_step)
        try:
            batch = next(it)
            self.rows.append(rows_of(batch, self.data, self.l_in))
            yield batch
        finally:
            it.close()


def rows_of(batch: dict, data: dict, l_in: int) -> np.ndarray:
    """The window starts of a loader batch: given (``starts``), or found in
    the split by each window's first step and checked whole; -1 for a row that
    is no window of the split or is marked not valid."""
    valid = np.asarray(batch.get("valid", np.ones(len(next(iter(batch.values()))), dtype=bool)))
    if "starts" in batch:
        return np.where(valid, np.asarray(batch["starts"], dtype=np.int64), -1)
    x_all = data["X"]
    first = {x_all[t].tobytes(): t for t in range(len(x_all) - l_in + 1)}
    rows = []
    for j in range(len(batch["x"])):
        t = first.get(np.ascontiguousarray(batch["x"][j][0]).tobytes(), -1)
        if t >= 0:
            x, tf, y = traffic_lib.windows_of(data, np.array([t]), l_in)
            whole = (np.array_equal(batch["x"][j], x[0]) and np.array_equal(batch["time_features"][j], tf[0])
                     and np.array_equal(batch["y"][j], y[0]))
            t = t if whole and valid[j] else -1
        rows.append(t)
    return np.asarray(rows, dtype=np.int64)


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def setup(ctx):
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.training.trainer import Trainer

    if ctx.world > 1:
        from tec_mollm_tpu_torch.parallel.mesh import init_distributed

        init_distributed(device=ctx.device, init_method=f"file://{ctx.store}/store")
    cfg = common.program_config(ctx)
    windows = int(ctx.traffic["train_windows"])
    data = traffic_lib.split(ctx.config, windows, ctx.seed, stream=0)
    ds = SlidingWindowDataset(data, cfg.train.L_in, cfg.train.L_out, stride=1)
    trainer = Trainer(cfg, ds, None, common.program_graph(ctx), None, workdir=ctx.tmp, run_name="bench",
                      device=ctx.device)
    initial = common.seeded_weights(ctx)
    trainer.set_params(initial)
    start = {k: initial[k].clone() for k in trainer.state.trainable()}
    del initial

    losses, recorded, ambiguous = [], [], 0
    loader = trainer.train_loader
    steps = trainer.train_loader = _Steps(loader, data, cfg.train.L_in)
    try:
        for step in range(CHECK_STEPS):
            with masks_lib.Recorder() as rec:
                losses.append(trainer.train_epoch(start_step=step, checkpoints=False)["train_loss"])
            recorded.append(rec.masks)
            ambiguous += rec.ambiguous
            if step == 0:
                state = trainer.state.optimizer.state
                first = {k: state[p]["exp_avg"] / (1.0 - BETA1) for k, p in trainer.state.trainable().items()}
                grad_norms = leaf_norms(first)
                del first
    finally:
        trainer.train_loader = loader
    change = leaf_norms({k: p.detach() - start[k] for k, p in trainer.state.trainable().items()})
    del start
    # the rest of epoch 0: the warm-up
    trainer.train_epoch(start_step=CHECK_STEPS, checkpoints=False)
    trainer.epoch = 1
    return {"ctx": ctx, "trainer": trainer, "data": data, "windows": len(ds),
            "program": {"loss": losses, "grad_norms": grad_norms, "change": change},
            "followed": {"rows": steps.rows, "masks": recorded, "ambiguous": ambiguous}}


def _all_done(done: bool, ctx) -> bool:
    if ctx.world == 1:
        return done
    flag = torch.tensor([1.0 if done else 0.0], device=ctx.device if ctx.device.type == "cuda" else "cpu")
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def _epoch(s) -> None:
    s["trainer"].train_epoch(checkpoints=False)
    s["trainer"].epoch += 1


def window(s, seconds: float) -> dict:
    ctx = s["ctx"]
    trainer = s["trainer"]
    trace_lib.sync(ctx.device)
    t0 = time.perf_counter()
    epochs, ends = 0, []
    while True:
        _epoch(s)
        epochs += 1
        ends.append(time.perf_counter() - t0)
        if _all_done(time.perf_counter() - t0 >= seconds, ctx):
            break
    elapsed = time.perf_counter() - t0
    done = epochs * s["windows"]
    return {
        "metrics": {"train_windows_per_s": done / elapsed},
        "attempted": done,
        "failed": 0,
        "windows": done,
        "elapsed_s": elapsed,
        "notes": {"epochs": epochs, "windows_per_epoch": s["windows"], "train_step": trainer.state.step,
                  "epoch_s": [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]},
    }


def traced(s) -> dict:
    """One whole epoch under the profiler, host operations left out: the loop
    is host-bound, and recording every host op would slow it by a third."""
    t = trace_lib.Capture(s["ctx"].device, host_ops=False)
    with t:
        _epoch(s)
    summary = trace_lib.reduce(t)
    summary["windows"] = s["windows"]
    return {"trace": summary}


def check(s) -> list[tuple[str, float, float]]:
    ctx = s["ctx"]
    program = s["program"]
    data = s["data"]
    del s["trainer"]
    common.free(ctx.device)
    followed = [s.pop("followed")]
    if ctx.world > 1:
        every = [None] * ctx.world if ctx.rank == 0 else None
        dist.gather_object(followed[0], every, dst=0)
        followed = every
    if ctx.rank != 0:
        return []
    batches = [[f["rows"][step] for f in followed] for step in range(CHECK_STEPS)]
    if min(int(r.min()) for ranks in batches for r in ranks) < 0:
        print("a check step's batch held a row that is no window of the split", file=sys.stderr)
        return [("rows_found", 1.0, 0.0)]

    replays = []

    def replay(step, rank):
        replays.append(masks_lib.Replay(followed[rank]["masks"][step], ctx.device))
        return replays[-1]

    try:
        refs = reference_steps(ctx, data, ref.Precision(), batches, replay)
    except ValueError as e:  # the program's masks do not fit the reference's sites
        print(f"the reference cannot follow the program's dropout: {e}", file=sys.stderr)
        return [("masks_followed", 1.0, 0.0)]
    print(f"dropout masks followed: {sum(len(r.masks) for r in replays)}, units counted "
          f"{sum(r.counted for r in replays)}, ambiguous {sum(f['ambiguous'] for f in followed)}", file=sys.stderr)
    drop = ("drop_rate_gap", masks_lib.drop_rate_gap(replays), ctx.limits.get("drop_rate_gap", 0.0))
    return compare(program, refs, ctx.limits) + [drop]


def reference_steps(ctx, data: dict, prec: ref.Precision, batches: list[list], masks,
                    half_batch: bool = False) -> dict:
    """The reference's steps over ``batches`` (``ref_train.run_steps``) from
    the seeded weights, with each leaf's change after the last."""
    params, dims, graph = common.reference_setup(ctx)
    start = {k: v.detach().clone() for k, v in params.items() if ref.trainable(k)}

    def windows(rows):
        starts = np.asarray(rows)  # stride 1: a window's index is its start
        x, tf, y = traffic_lib.windows_of(data, starts, dims.l_in)
        return (torch.as_tensor(x, device=ctx.device), torch.as_tensor(tf, device=ctx.device),
                torch.as_tensor(y, device=ctx.device))

    out = ref_train.run_steps(params, windows, batches, ctx.config, graph, prec, masks, half_batch=half_batch)
    out["change"] = {k: float(torch.linalg.vector_norm(v - start[k])) for k, v in out.pop("params").items()}
    return out


def compare(program: dict, refs: dict, limits: dict) -> list[tuple[str, float, float]]:
    """The loss of each step against the reference's, relative; the first
    gradient's and the change's norms leaf by leaf, each gap over the larger of
    the leaf's reference norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to rounding,
    moved by AdamW's round-off alone) are left out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], refs["loss"]))
    g_ref = refs["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    grad_gap = max(abs(program["grad_norms"][k] - v) / max(v, g_med) for k, v in g_ref.items())
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    c_ref = refs["change"]
    c_med = float(np.median([c_ref[k] for k in moved]))
    change_gap = max(abs(program["change"][k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved)
    return [
        ("loss_gap", loss_gap, limits.get("loss_gap", 0.0)),
        ("grad_gap", grad_gap, limits.get("grad_gap", 0.0)),
        ("change_gap", change_gap, limits.get("change_gap", 0.0)),
    ]


def close(s) -> None:
    s.pop("trainer", None)
