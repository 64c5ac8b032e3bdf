"""PyTorch port: data parallelism on 2 gloo ranks on the CPU against 1 rank.

The ranks are processes of tests/torch_ddp_worker.py (one intra-op thread
each). A 2-rank ``Trainer`` at batch 1 trains the same global macro batch as
1 rank at batch 2: 13 train windows in macro batches of 4 leave a last batch
of 1 valid window, all on rank 0, so the ranks' valid counts differ, and the
loss must still be the global mean (partition invariance). Per-epoch losses
within 1e-5 relative, per-horizon MAE and RMSE within 1e-4, on both ranks
alike. Then the evaluation library on the best checkpoint: ``run_evaluation``,
``get_model_predictions`` (window order), ``run_prediction`` and adaptive
conformal give every rank the 1-rank results. Only rank 0 writes (an audit
hook lists each rank's writes). A SIGTERM to rank 1 alone stops both ranks at
one epoch boundary; a mid-epoch checkpoint of 2 ranks is refused at 1, an
epoch-boundary one resumes. The train CLI runs with ``--multihost --cpu``,
also on the device-resident archive. (The JAX dp=2 parity is
tests/test_torch_ddp_jax.py.)"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from test_torch_trainer import _cfg, _trainer, _write_processed

from tec_mollm_tpu_torch.data import SlidingWindowDataset
from tec_mollm_tpu_torch.evaluation.conformal import evaluate_adaptive_conformal
from tec_mollm_tpu_torch.evaluation.harness import (
    get_model_predictions,
    load_params_for_eval,
    run_evaluation,
    run_prediction,
)
from tec_mollm_tpu_torch.graph import GraphData
from tec_mollm_tpu_torch.models import TECMoLLM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ddp_worker.py")
# train 13 (macro batches of 4: the last holds 1 window, on rank 0), val 9
# (the last validation batch is rank 0's alone), test 21 (6 eval batches of 4)
WINDOWS = (13, 9, 21)
WORLD = 2


def ddp_cfg(batch_size: int, **train):
    """fp32, every dropout 0, shuffled, stride 1: rank parity is exact math."""
    return _cfg(dropout=False, lr=1e-3, batch_size=batch_size, accumulation_steps=2, train_stride=1, **train)


class Ranks:
    """``world`` worker processes (tests/torch_ddp_worker.py) running one job,
    started at construction; ``wait`` gives their rank<r>.json records. Each rank's stdout and stderr go to
    ``<out>/rank<r>.log``, a file, so that no rank ever blocks on a full pipe
    while the test waits on another."""

    def __init__(self, tmp, name: str, job: dict, world: int):
        self.out = os.path.join(tmp, f"{name}_out")
        os.makedirs(self.out, exist_ok=True)
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump({**job, "out": self.out}, f)
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        self.logs = [os.path.join(self.out, f"rank{r}.log") for r in range(world)]
        self.started = time.monotonic()
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen([sys.executable, WORKER, path, str(r), str(world)], env=env,
                                                   stdout=f, stderr=subprocess.STDOUT))

    def wait(self, timeout: float) -> list[dict]:
        """The records, once every rank exits 0 within ``timeout`` seconds of
        the start; else an assertion that holds each failing rank's output."""
        try:
            for p in self.procs:
                p.wait(timeout=max(timeout - (time.monotonic() - self.started), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            running = [p.poll() is None for p in self.procs]
            for p in self.procs:
                p.kill()
                p.wait()
        elapsed = time.monotonic() - self.started
        for r, (p, log, killed) in enumerate(zip(self.procs, self.logs, running)):
            why = f"was killed at the {timeout:.0f} s limit" if killed else f"exited {p.returncode}"
            assert not killed and p.returncode == 0, f"rank {r} {why} after {elapsed:.1f} s:\n{open(log).read()[-4000:]}"
        return [json.load(open(os.path.join(self.out, f"rank{r}.json"))) for r in range(len(self.procs))]


def run_ranks(tmp, name: str, job: dict, world: int = WORLD, timeout: float = 240) -> list[dict]:
    """Run ``job`` on ``world`` worker processes; their rank<r>.json records."""
    return Ranks(tmp, name, job, world).wait(timeout)


def arrays(records_dir: str, r: int) -> dict:
    with np.load(os.path.join(records_dir, f"rank{r}.npz")) as d:
        return dict(d)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank fit and evaluation, and the same on 1 rank in this process."""
    base = str(tmp_path_factory.mktemp("ddp"))
    proc = _write_processed(os.path.join(base, "proc"), ddp_cfg(1), windows=WINDOWS)
    cfg_path = os.path.join(base, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(ddp_cfg(1).to_json())
    work = os.path.join(base, "w2")
    records = run_ranks(base, "fit", {"kind": "fit", "config": cfg_path, "data": proc, "workdir": work,
                                      "eval": True})

    one = ddp_cfg(2)
    w1 = os.path.join(base, "w1")
    trainer = _trainer(one, proc, w1)
    ref = {"history": trainer.fit(), "updates": trainer.state.step}
    val_loss, metrics = trainer.validate()
    ref["validate"] = {"val_loss": val_loss, **metrics}
    ckpt = os.path.join(w1, "checkpoints", "run", "best_params.pt")
    ref["eval"] = run_evaluation(one, proc, ckpt, output_dir=os.path.join(w1, "results"), batch_size=4,
                                 workdir=w1, device="cpu")["results"]
    ref["pred_forecast"] = run_prediction(one, proc, ckpt, indices=[0, 3, 4], output_dir=os.path.join(w1, "results"),
                                          workdir=w1, device="cpu")["forecast"]
    graph = GraphData.load(os.path.join(proc, "graph.npz"))
    val = SlidingWindowDataset.from_dir(proc, "val", one.train.L_in, one.train.L_out, stride=1)
    ref["gmp_true"], ref["gmp_pred"] = get_model_predictions(one, load_params_for_eval(one, ckpt), val, graph,
                                                             batch_size=4, device="cpu")
    qcfg = dataclasses.replace(one, model=dataclasses.replace(one.model, quantiles=(0.1, 0.5, 0.9))).resolved()
    test = SlidingWindowDataset.from_dir(proc, "test", one.train.L_in, one.train.L_out, stride=1)
    ref["aci"] = evaluate_adaptive_conformal(qcfg, TECMoLLM(qcfg.model, seed=1).state_dict(), test, graph,
                                             trainer.target_scaler, batch_size=4, min_residual_mass=100.0,
                                             device="cpu")
    return {"base": base, "proc": proc, "cfg_path": cfg_path, "work": work, "records": records,
            "out": os.path.join(base, "fit_out"), "ref": ref}


def test_two_ranks_train_the_one_rank_run(two_ranks):
    """Partition invariance: the same global macro batches, the last one
    split 1 : 0 over the ranks, give the 1-rank losses and metrics."""
    ref = two_ranks["ref"]
    for rec in two_ranks["records"]:
        assert len(rec["history"]) == len(ref["history"]) == 2
        assert rec["updates"] == ref["updates"] == 8
        for got, want in zip(rec["history"], ref["history"]):
            assert got["updates"] == want["updates"] == 4
            assert got["train_loss"] == pytest.approx(want["train_loss"], rel=1e-5)
            assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
        for k in ("mae_by_horizon", "rmse_by_horizon"):
            np.testing.assert_allclose(rec["validate"][k], ref["validate"][k], rtol=1e-4, err_msg=k)
        assert rec["validate"]["val_loss"] == pytest.approx(ref["validate"]["val_loss"], rel=1e-5)


def test_every_rank_returns_the_same_numbers(two_ranks):
    r0, r1 = two_ranks["records"]
    assert r0["history"] == [{**h, "windows_per_sec": r0["history"][i]["windows_per_sec"]}
                             for i, h in enumerate(r1["history"])]
    assert r0["validate"] == r1["validate"] and r0["best_val_loss"] == r1["best_val_loss"]
    assert r0["eval"] == r1["eval"] and r0["aci"] == r1["aci"]
    a0, a1 = arrays(two_ranks["out"], 0), arrays(two_ranks["out"], 1)
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_only_rank_0_writes(two_ranks):
    r0, r1 = two_ranks["records"]
    assert r1["writes"] == []
    for f in ("logs/run.jsonl", "checkpoints/run/best_params.pt", "checkpoints/run/latest.pt",
              "checkpoints/run/latest.meta.json", "results/evaluation_results.csv",
              "results/evaluation_summary.txt", "results/forecast.npz"):
        assert f in r0["writes"], f
    lines = open(os.path.join(two_ranks["work"], "logs", "run.jsonl")).read().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    meta = json.load(open(os.path.join(two_ranks["work"], "checkpoints", "run", "latest.meta.json")))
    assert (meta["process_count"], meta["epoch"], meta["step_in_epoch"]) == (2, 1, 0)


def test_evaluation_gives_every_rank_the_one_rank_results(two_ranks):
    ref = two_ranks["ref"]
    for r, rec in enumerate(two_ranks["records"]):
        for model in ("TEC-MoLLM", "HistoricalAverage"):
            for k in ("mae_avg", "rmse_avg"):
                assert rec["eval"][model][k] == pytest.approx(ref["eval"][model][k], rel=1e-5), (model, k)
            # r and R^2 lie in [-1, 1] and come from differences of sums that
            # each rank adds in fp32 over other batches: held absolutely
            for k in ("r2_score_avg", "pearson_r_avg"):
                assert rec["eval"][model][k] == pytest.approx(ref["eval"][model][k], abs=1e-5), (model, k)
            np.testing.assert_allclose(rec["eval"][model]["mae_by_horizon"], ref["eval"][model]["mae_by_horizon"],
                                       rtol=1e-5)
        got = arrays(two_ranks["out"], r)
        # the full tensor in window order: an order-sensitive comparison
        assert got["gmp_pred"].shape == ref["gmp_pred"].shape == (WINDOWS[1], 4, 48, 1)
        np.testing.assert_allclose(got["gmp_pred"], ref["gmp_pred"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["gmp_true"], ref["gmp_true"])
        np.testing.assert_allclose(got["pred_forecast"], ref["pred_forecast"], rtol=1e-5, atol=1e-5)


def test_adaptive_conformal_evolves_the_one_rank_state(two_ranks):
    ref = two_ranks["ref"]["aci"]
    assert ref["adaptive"]["batches_on_adaptive_offsets"] > 0
    for rec in two_ranks["records"]:
        aci = rec["aci"]
        assert aci["batches"] == ref["adaptive"]["batches"] == 6
        np.testing.assert_allclose(aci["final_effective_levels"], ref["adaptive"]["final_effective_levels"],
                                   atol=1e-4)
        assert aci["interval_coverage"] == pytest.approx(ref["interval_coverage"], abs=1e-6)
        assert aci["pinball_avg"] == pytest.approx(ref["pinball_avg"], rel=1e-5)
        np.testing.assert_allclose(aci["calibration_by_level"], ref["calibration_by_level"], atol=1e-6)


def test_epoch_boundary_checkpoint_of_two_ranks_resumes_on_one(two_ranks, tmp_path):
    work = str(tmp_path / "w")
    shutil.copytree(two_ranks["work"], work)
    trainer = _trainer(ddp_cfg(2, epochs=3), two_ranks["proc"], work)
    history = trainer.fit(resume=True)
    assert [r["epoch"] for r in history] == [2] and history[0]["updates"] == 4
    assert trainer.state.step == 12


def test_mid_epoch_checkpoint_of_two_ranks_is_refused_on_one(two_ranks, tmp_path):
    """Step k of an epoch counts macro steps of one process count: resuming it
    under another would skip or repeat windows."""
    cfg = ddp_cfg(1, checkpoint_every_steps=3)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    work = str(tmp_path / "w")
    (r0, _) = run_ranks(str(tmp_path), "mid", {"kind": "fit", "config": cfg_path, "data": two_ranks["proc"],
                                               "workdir": work, "epoch_only": True})
    assert r0["epoch"]["steps_in_epoch"] == 4
    meta = json.load(open(os.path.join(work, "checkpoints", "run", "latest.meta.json")))
    assert (meta["step_in_epoch"], meta["process_count"]) == (3, 2)
    with pytest.raises(RuntimeError, match="process_count: saved 2 vs current 1"):
        _trainer(cfg, two_ranks["proc"], work).fit(resume=True)


def test_sigterm_to_one_rank_stops_every_rank_at_one_epoch(two_ranks, tmp_path):
    work = str(tmp_path / "w")
    records = run_ranks(str(tmp_path), "stop", {
        "kind": "fit", "config": two_ranks["cfg_path"], "data": two_ranks["proc"], "workdir": work,
        "epochs": 4, "stop_rank": 1, "stop_epoch": 1,
    })
    epochs = {rec["final_epoch"] for rec in records}
    assert len(epochs) == 1, epochs
    (stopped,) = epochs
    assert 1 <= stopped < 3  # stopped by the signal, not by the epoch count
    assert all(len(rec["history"]) == stopped + 1 for rec in records)
    meta = json.load(open(os.path.join(work, "checkpoints", "run", "latest.meta.json")))
    assert (meta["epoch"], meta["step_in_epoch"]) == (stopped, 0)


def test_train_cli_multihost_on_two_ranks(two_ranks, tmp_path):
    """python -m tec_mollm_tpu_torch.train --multihost --cpu under torchrun's
    environment: both ranks train, rank 0 alone writes config.json, the
    checkpoints and the history."""
    work = str(tmp_path / "w")
    argv = ["--config", two_ranks["cfg_path"], "--data-dir", two_ranks["proc"], "--workdir", work,
            "--run-name", "r", "--epochs", "1"]
    r0, r1 = run_ranks(str(tmp_path), "cli", {"kind": "cli", "argv": argv, "workdir": work})
    assert len(r0["history"]) == len(r1["history"]) == 1
    assert r0["history"][0]["val_loss"] == r1["history"][0]["val_loss"]
    assert r1["writes"] == []
    assert {"checkpoints/r/config.json", "checkpoints/r/best_params.pt", "logs/r.jsonl"} <= set(r0["writes"])
    assert sorted(os.listdir(os.path.join(work, "checkpoints", "r"))) == [
        "best_params.pt", "config.json", "latest.meta.json", "latest.pt"]
    assert len(open(os.path.join(work, "logs", "r.jsonl")).read().splitlines()) == 1


def test_device_resident_archive_on_two_ranks(tmp_path):
    """--device-data: every rank holds the whole raw series and gathers its
    own shard's windows there; 2 ranks at batch 1 train the 1-rank run at
    batch 2."""
    from tec_mollm_tpu_torch import train as train_cli
    from tec_mollm_tpu_torch.data.preprocess import run_preprocess

    data = str(tmp_path / "archive")
    run_preprocess(ddp_cfg(1).data, data, synthetic_steps=300, synthetic_grid=(6, 8))
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(ddp_cfg(1).to_json())
    argv = ["--config", cfg_path, "--data-dir", data, "--run-name", "r", "--epochs", "2", "--train-stride", "4",
            "--device-data"]
    ranks = run_ranks(str(tmp_path), "dev", {"kind": "cli", "argv": argv + ["--workdir", str(tmp_path / "w2")],
                                             "workdir": str(tmp_path / "w2")})
    one = train_cli.main(argv + ["--workdir", str(tmp_path / "w1"), "--cpu", "--batch-size", "2"])
    for rec in ranks:
        assert [h["updates"] for h in rec["history"]] == [h["updates"] for h in one]
        for got, want in zip(rec["history"], one):
            assert got["train_loss"] == pytest.approx(want["train_loss"], rel=1e-5)
            assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
