"""PyTorch port: tensor parallelism on gloo ranks on the CPU against 1 rank.

One spawn of 4 ranks (processes of tests/torch_ddp_worker.py, one intra-op
thread each) runs every stage in turn, each in a process group of its own:

* ``mp2``: dp 1 x mp 2, the ``Trainer`` at batch 2 (the 1-rank run's global
  macro batch), then the evaluation library on its best checkpoint;
* ``dp2mp2``: dp 2 x mp 2 at batch 1 a data rank, the same global batch,
  then ``run_evaluation`` at batch 5, which the 2 data ranks round up to 6;
* ``grad``: two train steps of a fresh dp 1 x mp 2 ``Trainer`` with a clip
  that engages: the second step's clip norm and whole clipped gradients;
* ``mid``: a dp 1 x mp 2 epoch with a checkpoint every 3 macro steps;
* ``cli``: ``python -m tec_mollm_tpu_torch.train --multihost --model-parallel 2``
  in bf16 (frozen weights stored in bf16, the split products in bf16), from
  an HF GPT-2 checkpoint (``--gpt2-checkpoint``);
* ``bench1`` / ``bench2``: ``python -m tec_mollm_tpu_torch.bench --quick
  --cpu`` at world 1 and 2.

Each stage's group meets at a file store of its own, made when the stage
starts (tests/torch_ddp_worker.py): a port picked before the spawn could be
taken by another process by the time a later stage binds it. The 1-rank
references run in this process while the ranks run.

Every config is fp32 with every dropout at 0, so the splits change only the
order of fp32 sums: losses within 1e-5 relative of 1 rank, the same best
epoch, validation and eval metrics identical on every rank. The layout
helpers (shard / gather, the per-head split) run in this process. The JAX
package's dp x tp parity is tests/test_torch_tp_jax.py."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from test_torch_ddp import WINDOWS, Ranks, arrays, ddp_cfg
from test_torch_trainer import _trainer, _write_processed

from tec_mollm_tpu_torch import bench, parallel
from tec_mollm_tpu_torch.config import tiny_config
from tec_mollm_tpu_torch.evaluation.harness import run_evaluation
from tec_mollm_tpu_torch.models import TECMoLLM
from tec_mollm_tpu_torch.parallel.partitioning import param_split
from tec_mollm_tpu_torch.parallel.tensor_parallel import (
    gather_full_state_dict,
    model_plan,
    shard_model_,
    shard_state_dict,
)
from tec_mollm_tpu_torch.serving import ForecastService
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLIP = 1e-3  # the grad stage's clip: far below the tiny model's gradient norm
# the dp2mp2 stage's extra evaluation batch: not a multiple of its 2 data ranks
ODD_EVAL_BATCH = 5


def _write_cfg(path, cfg) -> str:
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tp"))
    proc = _write_processed(os.path.join(base, "proc"), ddp_cfg(1), windows=WINDOWS)
    b2 = _write_cfg(os.path.join(base, "b2.json"), ddp_cfg(2))
    b1 = _write_cfg(os.path.join(base, "b1.json"), ddp_cfg(1))
    clip = _write_cfg(os.path.join(base, "clip.json"), ddp_cfg(2, clip_grad_norm=CLIP))
    mid = _write_cfg(os.path.join(base, "mid.json"), ddp_cfg(2, checkpoint_every_steps=3))
    bf16 = _write_cfg(os.path.join(base, "bf16.json"), ddp_cfg(2, bf16=True))
    # an HF GPT-2 state_dict for the CLI's --gpt2-checkpoint: another init's
    # backbone, moved off it, without LoRA
    backbone = TECMoLLM(ddp_cfg(2).model, seed=7).llm_backbone.model.state_dict()
    gpt2 = os.path.join(base, "gpt2.pt")
    torch.save({f"transformer.{k}": v + 0.5 for k, v in backbone.items() if ".lora_" not in k}, gpt2)
    work = {k: os.path.join(base, k) for k in ("mp2", "dp2mp2", "grad", "mid", "cli")}
    common = {"kind": "fit", "data": proc, "model_parallel": 2}
    stages = [
        {**common, "name": "mp2", "world": 2, "config": b2, "workdir": work["mp2"], "eval": True,
         "record_params": True},
        {**common, "name": "dp2mp2", "world": 4, "config": b1, "workdir": work["dp2mp2"],
         "eval_batch": ODD_EVAL_BATCH},
        {**common, "kind": "grad", "name": "grad", "world": 2, "config": clip, "workdir": work["grad"]},
        {**common, "name": "mid", "world": 2, "config": mid, "workdir": work["mid"], "epoch_only": True},
        {"kind": "cli", "name": "cli", "world": 2, "model_parallel": 2, "argv": [
            "--config", bf16, "--data-dir", proc, "--workdir", work["cli"], "--run-name", "r", "--epochs", "1",
            "--model-parallel", "2", "--gpt2-checkpoint", gpt2]},
        {"kind": "bench", "name": "bench1", "world": 1, "argv": ["--quick", "--cpu"]},
        {"kind": "bench", "name": "bench2", "world": 2, "argv": ["--quick", "--cpu"]},
    ]
    ranks = Ranks(base, "tp", {"kind": "stages", "workdir": base, "stages": stages}, world=4)

    # 1 rank at the same global macro batch
    one = ddp_cfg(2)
    w1 = os.path.join(base, "w1")
    trainer = _trainer(one, proc, w1)
    ref = {"history": trainer.fit()}
    val_loss, metrics = trainer.validate()
    ref["validate"] = {"val_loss": val_loss, **metrics}
    g = _trainer(ddp_cfg(2, clip_grad_norm=CLIP), proc, os.path.join(base, "g1"), run_name="grad")
    g.train_loader.set_epoch(0)
    for batch in list(g.train_loader)[:2]:  # the first step moves lora_B off 0
        g.state, m = g._train_step(g.state, g._put(batch), g.graph)
    ref["grad_norm"] = float(m["grad_norm"])
    ref["grads"] = {n: p.grad.clone() for n, p in g.state.trainable().items()}
    records = ranks.wait(timeout=400)
    return {"base": base, "proc": proc, "work": work, "records": records, "out": ranks.out, "ref": ref,
            "gpt2": gpt2}


def _stage(tp, name):
    return [r[name] for r in tp["records"] if name in r]


def _held_to_one_rank(recs, ref):
    for rec in recs:
        assert len(rec["history"]) == len(ref["history"]) == 2
        for got, want in zip(rec["history"], ref["history"]):
            assert got["updates"] == want["updates"] == 4
            assert got["train_loss"] == pytest.approx(want["train_loss"], rel=1e-5)
            assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
        best = [int(np.argmin([h["val_loss"] for h in hist])) for hist in (rec["history"], ref["history"])]
        assert best[0] == best[1]
        assert rec["validate"]["val_loss"] == pytest.approx(ref["validate"]["val_loss"], rel=1e-5)
        np.testing.assert_allclose(rec["validate"]["mae_by_horizon"], ref["validate"]["mae_by_horizon"], rtol=1e-5)
    assert all(r["validate"] == recs[0]["validate"] for r in recs)
    assert all([h["val_loss"] for h in r["history"]] == [h["val_loss"] for h in recs[0]["history"]] for r in recs)


def test_dp1_mp2_trains_the_one_rank_run(tp):
    recs = _stage(tp, "mp2")
    assert len(recs) == 2
    _held_to_one_rank(recs, tp["ref"])


def test_dp2_mp2_trains_the_one_rank_run(tp):
    recs = _stage(tp, "dp2mp2")
    assert len(recs) == 4
    _held_to_one_rank(recs, tp["ref"])


def test_dp2_eval_rounds_an_odd_batch_up_and_equals_one_rank(tp, tmp_path):
    """Batch 5 over 2 data ranks runs as 6 (logged, as the JAX executor logs
    it); the padding rows are invalid, so every rank's metrics are one
    process's at batch 5 on the same checkpoint."""
    recs = [r["eval_batch"] for r in _stage(tp, "dp2mp2")]
    assert all(r["log"] == ["eval batch size 5 -> 6 (must tile the 2 data-parallel ranks)"] for r in recs)
    assert all(r["results"] == recs[0]["results"] for r in recs)
    work = tp["work"]["dp2mp2"]
    want = run_evaluation(ddp_cfg(1), tp["proc"], os.path.join(work, "checkpoints", "run", "best_params.pt"),
                          output_dir=str(tmp_path), batch_size=ODD_EVAL_BATCH, workdir=work,
                          device="cpu")["results"]
    for model in ("TEC-MoLLM", "HistoricalAverage"):
        got = recs[0]["results"][model]
        for k in ("mae_avg", "rmse_avg"):  # relative; r and R^2 (near 0 here) absolute
            assert got[k] == pytest.approx(want[model][k], rel=1e-5), (model, k)
        for k in ("r2_score_avg", "pearson_r_avg"):
            assert got[k] == pytest.approx(want[model][k], abs=1e-5), (model, k)
        np.testing.assert_allclose(got["mae_by_horizon"], want[model]["mae_by_horizon"], rtol=1e-5)


def test_each_rank_holds_its_slices(tp):
    """c_attn (64, 192) at mp 2: (64, 96) on each rank; the checkpoint whole."""
    assert [r["c_attn_shape"] for r in _stage(tp, "mp2")] == [[64, 96], [64, 96]]
    best = torch.load(os.path.join(tp["work"]["mp2"], "checkpoints", "run", "best_params.pt"), weights_only=True)
    want = TECMoLLM(ddp_cfg(2).model).state_dict()
    assert {k: tuple(v.shape) for k, v in best.items()} == {k: tuple(v.shape) for k, v in want.items()}


def test_clip_norm_is_the_one_rank_norm(tp):
    for rec in _stage(tp, "grad"):
        assert rec["grad_norm"] == pytest.approx(tp["ref"]["grad_norm"], rel=1e-5)
        assert rec["grad_norm"] > 10 * CLIP  # the clip engaged


@pytest.mark.parametrize("name", ["lora_A", "lora_B", "prediction_head"])
def test_clipped_gradients_are_the_one_rank_gradients(tp, name):
    """lora_A, replicated inside the split c_attn, holds each rank's partial
    gradient until the step sums it over the model group: without that sum
    this comparison fails."""
    ref = tp["ref"]["grads"]
    names = [n for n in ref if name in n]
    assert names and all(ref[n].abs().max() > 0 for n in names)
    for r in range(2):
        got = arrays(tp["out"], r)
        for n in names:
            np.testing.assert_allclose(got[f"grad/grad:{n}"], ref[n].numpy(), rtol=1e-4, atol=1e-9, err_msg=n)


def test_evaluation_on_the_ranks_is_one_process_on_the_checkpoint(tp, tmp_path):
    recs = _stage(tp, "mp2")
    assert recs[0]["eval"] == recs[1]["eval"] and recs[0]["aci"] == recs[1]["aci"]
    ckpt = os.path.join(tp["work"]["mp2"], "checkpoints", "run", "best_params.pt")
    want = run_evaluation(ddp_cfg(2), tp["proc"], ckpt, output_dir=str(tmp_path), batch_size=4,
                          workdir=tp["work"]["mp2"], device="cpu")["results"]
    for model in ("TEC-MoLLM", "HistoricalAverage"):
        for k in ("mae_avg", "rmse_avg"):
            assert recs[0]["eval"][model][k] == pytest.approx(want[model][k], rel=1e-5), (model, k)
    a0, a1 = arrays(tp["out"], 0), arrays(tp["out"], 1)
    for k in ("mp2/gmp_pred", "mp2/pred_forecast"):
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_mp2_checkpoint_serves_on_one_process(tp):
    ckpt = os.path.join(tp["work"]["mp2"], "checkpoints", "run", "best_params.pt")
    sd = torch.load(ckpt, weights_only=True)
    service = ForecastService(ddp_cfg(2), tp["proc"], state_dict=sd, batch_window_ms=0, device="cpu")
    try:
        out = service.forecast([0, 1], split="test")
    finally:
        service.close()
    assert np.isfinite(np.asarray(out["forecast"])).all()


def test_epoch_boundary_mp2_checkpoint_resumes_at_mp1_bit_identical(tp, tmp_path):
    work = str(tmp_path / "w")
    shutil.copytree(tp["work"]["mp2"], work)
    trainer = _trainer(ddp_cfg(2, epochs=3), tp["proc"], work)
    trainer.state, meta = trainer.ckpt.restore_state(trainer.state, "latest")
    assert (meta["epoch"], meta["step_in_epoch"], meta["config"]["train"]["model_parallel"]) == (1, 0, 2)
    got = arrays(tp["out"], 0)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[f"mp2/param:{k}"], err_msg=k)
    trainer = _trainer(ddp_cfg(2, epochs=3), tp["proc"], work)
    history = trainer.fit(resume=True)
    assert [r["epoch"] for r in history] == [2] and trainer.state.step == 12


def test_mid_epoch_mp2_checkpoint_is_refused_at_mp1(tp):
    (r0, _) = _stage(tp, "mid")
    assert r0["epoch"]["steps_in_epoch"] == 4
    meta = json.load(open(os.path.join(tp["work"]["mid"], "checkpoints", "run", "latest.meta.json")))
    assert meta["step_in_epoch"] == 3
    with pytest.raises(RuntimeError, match="model_parallel: saved 2 vs current 1"):
        _trainer(ddp_cfg(2, checkpoint_every_steps=3), tp["proc"], tp["work"]["mid"]).fit(resume=True)


def test_train_cli_model_parallel_2_under_torchrun(tp):
    """bf16 from an imported GPT-2: the ranks agree with each other exactly;
    the checkpoint holds whole tensors, the frozen ones the import's, in
    bf16."""
    r0, r1 = _stage(tp, "cli")
    assert len(r0["history"]) == len(r1["history"]) == 1
    assert r0["history"][0]["val_loss"] == r1["history"][0]["val_loss"]
    assert np.isfinite(r0["history"][0]["train_loss"])
    run = os.path.join(tp["work"]["cli"], "checkpoints", "r")
    assert json.load(open(os.path.join(run, "config.json")))["train"]["model_parallel"] == 2
    best = torch.load(os.path.join(run, "best_params.pt"), weights_only=True)
    hf = torch.load(tp["gpt2"], weights_only=True)
    frozen = [k for k in hf if any(f".{m}." in k for m in ("c_attn", "c_proj", "c_fc"))]
    assert len(frozen) == 2 * 8
    for k in frozen:
        got = best["llm_backbone.model." + k[len("transformer."):]]
        assert got.dtype == torch.bfloat16 and torch.equal(got, hf[k].to(torch.bfloat16)), k


def test_bench_under_two_ranks_doubles_the_windows_a_step(tp):
    (one,) = _stage(tp, "bench1")
    twos = _stage(tp, "bench2")
    assert twos[1]["line"] is None  # rank 0 prints
    line = twos[0]["line"]
    assert one["line"]["world"] == 1 and line["world"] == 2
    assert line["windows_per_step"] == 2 * one["line"]["windows_per_step"]
    assert line["value"] == pytest.approx(line["total_windows_per_sec"] / 2, rel=1e-3)


# ---------------------------------------------------------------------------
# the layout, in this process


@pytest.mark.parametrize("mp", [2, 4])
def test_gather_of_the_shards_is_the_state_dict(mp):
    cfg = tiny_config().model
    sd = TECMoLLM(cfg, seed=3).state_dict()
    shards = [shard_state_dict(sd, r, mp, cfg) for r in range(mp)]
    assert set(model_plan(cfg, mp)) and any(shards[0][k].shape != sd[k].shape for k in sd)
    back = gather_full_state_dict(shards, cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_c_attn_splits_by_head():
    """Rank m holds q, k and v of heads [m * H / mp, (m + 1) * H / mp)."""
    cfg = tiny_config().model  # d 64, 4 heads of 16
    sd = TECMoLLM(cfg, seed=0).state_dict()
    name = "llm_backbone.model.h.0.attn.c_attn"
    w, b, lb = sd[f"{name}.weight"], sd[f"{name}.bias"], sd[f"{name}.lora_B.weight"]
    part = shard_state_dict(sd, 1, 2, cfg)
    cols = torch.cat([torch.arange(32, 64) + 64 * j for j in range(3)])
    assert torch.equal(part[f"{name}.weight"], w[:, cols])
    assert torch.equal(part[f"{name}.bias"], b[cols])
    assert torch.equal(part[f"{name}.lora_B.weight"], lb[cols])
    assert torch.equal(part[f"{name}.lora_A.weight"], sd[f"{name}.lora_A.weight"])


def test_attention_stays_whole_when_the_heads_do_not_divide():
    """3 heads at mp 2: JAX's guard (3d % mp = 0) would split c_attn, but a
    per-head split needs whole heads, so the attention stays replicated;
    the MLP and the head still split."""
    cfg = tiny_config(d_llm=48, llm_heads=3).model
    assert param_split("llm_backbone.model.h.0.attn.c_attn.weight", (48, 144), 2) == "column"
    plan = model_plan(cfg, 2)
    assert not any(".attn." in k for k in plan)
    assert "llm_backbone.model.h.0.mlp.c_fc.weight" in plan and "prediction_head.mlp.0.weight" in plan


def test_param_split_guards_indivisible_dims():
    assert param_split("llm_backbone.model.h.0.attn.c_attn.weight", (4, 9), 2) == "replicated"
    assert param_split("llm_backbone.model.h.0.attn.c_attn.weight", (4, 12), 2) == "column"
    assert param_split("llm_backbone.model.h.0.attn.c_attn.lora_A.weight", (4, 4), 2) == "replicated"
    assert param_split("prediction_head.mlp.3.weight", (8, 6), 2) == "row"
    assert param_split("prediction_head.mlp.3.bias", (8,), 2) == "replicated"
    assert param_split("llm_backbone.model.h.0.attn.c_attn.weight", (4, 12), 1) == "replicated"


def test_shard_model_in_place_keeps_parameters_and_refuses_twice():
    model = TECMoLLM(tiny_config().model, seed=0)
    before = dict(model.named_parameters())
    shard_model_(model, 0, 2)
    assert all(p is before[n] for n, p in model.named_parameters())
    assert model.llm_backbone.model.h[0].attn.heads == 2 and model.prediction_head.split
    with pytest.raises(RuntimeError, match="split already"):
        shard_model_(model, 0, 2)


def test_model_group_helpers_without_a_group():
    assert (parallel.model_world(), parallel.model_rank(), parallel.data_world(), parallel.data_rank()) == (1, 0, 1, 0)
    assert parallel.model_group() is None and parallel.data_group() is None
    assert parallel.max_over_ranks(2.5) == 2.5


def test_init_distributed_refuses_a_world_not_divisible_by_mp(monkeypatch):
    for k, v in {"RANK": "0", "WORLD_SIZE": "3", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
        parallel.init_distributed(device="cpu", model_parallel=2)
    assert not parallel.is_initialized()


def test_trainer_refuses_mp_above_1_in_one_process(tmp_path):
    proc = _write_processed(str(tmp_path / "proc"), ddp_cfg(1))
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        _trainer(ddp_cfg(2, model_parallel=2), proc, tmp_path / "w")


def test_bench_without_a_group_is_unchanged(capsys):
    assert bench.main(["--quick", "--cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "device"}

