"""PyTorch port: the Trainer, its checkpoints, the train CLI and serving what
it writes (the parity with the JAX Trainer is tests/test_torch_trainer_jax.py).

Resume is exact on the CPU: a checkpoint restored into a fresh
Trainer, and a run stopped by SIGTERM after k macro steps then resumed, give
the trainable tensors of an uninterrupted run bit for bit (every dropout at its
default 0.1: the masks come from the step)."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu_torch import serve as serve_cli
from tec_mollm_tpu_torch import train as train_cli
from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler
from tec_mollm_tpu_torch.data.synthetic import synthetic_processed_split
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.serving import ForecastService
from tec_mollm_tpu_torch.training import make_sum_loss_fn
from tec_mollm_tpu_torch.training.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NO_DROPOUT = dict(gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0)
TARGET_MEAN, TARGET_SCALE = 25.0, 12.0


def _cfg(mod=pcfg, dropout=True, **train):
    c = mod.tiny_config()
    model = c.model if dropout else dataclasses.replace(c.model, **NO_DROPOUT)
    return dataclasses.replace(
        c, model=model,
        train=dataclasses.replace(c.train, **{"bf16": False, "epochs": 2, "batch_size": 2, "accumulation_steps": 2, **train}),
    ).resolved()


def _write_processed(path, cfg, stencil=True, windows=(13, 5, 5)):
    """{train,val,test}_set.npz, graph.npz (with or without its stencil) and
    target_scaler.npz of a tiny synthetic archive."""
    os.makedirs(path, exist_ok=True)
    m = cfg.model
    for (mode, n), seed in zip(zip(("train", "val", "test"), windows), range(3)):
        split = synthetic_processed_split(n, cfg.train.L_in, cfg.train.L_out, m.num_nodes, seed=seed)
        np.savez(os.path.join(path, f"{mode}_set.npz"), **split)
    graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
    if not stencil:
        graph = dataclasses.replace(graph, stencil_shifts=None, stencil_valid=None)
    graph.save(os.path.join(path, "graph.npz"))
    StandardScaler(np.array([TARGET_MEAN]), np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))
    return path


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    return _write_processed(str(tmp_path_factory.mktemp("proc")), _cfg())


def _trainer(cfg, data_dir, workdir, run_name="run"):
    t = cfg.train
    train = SlidingWindowDataset.from_dir(data_dir, "train", t.L_in, t.L_out, stride=1)
    val = SlidingWindowDataset.from_dir(data_dir, "val", t.L_in, t.L_out, stride=1)
    graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
    scaler = StandardScaler.load(os.path.join(data_dir, "target_scaler.npz"))
    return Trainer(cfg, train, val, graph, scaler, workdir=str(workdir), run_name=run_name, device="cpu")


def _trainable(trainer):
    return {n: p.detach().clone() for n, p in trainer.state.trainable().items()}


def _assert_identical(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


class _StopAfter(dict):
    """stop_requested whose flag turns True on its n-th read."""

    def __init__(self, n):
        super().__init__(flag=False)
        self.n, self.reads = n, 0

    def __getitem__(self, key):
        self.reads += key == "flag"
        return self.reads >= self.n if key == "flag" else super().__getitem__(key)


class TestResume:
    def test_restored_checkpoint_continues_bit_for_bit(self, proc, tmp_path):
        """save -> restore into a fresh Trainer -> the rest of the epoch equals
        the epoch run straight through (13 windows at macro batch 4: 3 full
        steps and a padded one)."""
        cfg = _cfg()
        a = _trainer(cfg, proc, tmp_path / "a")
        stats = a.train_epoch()
        assert stats["steps_in_epoch"] == 4 and stats["updates"] == 4
        want = _trainable(a)

        b = _trainer(cfg, proc, tmp_path / "b")
        assert b.train_epoch(0, _StopAfter(2))["steps_in_epoch"] == 2
        b._save_latest(step_in_epoch=2)
        c = _trainer(cfg, proc, tmp_path / "b")
        c.state, meta = c.ckpt.restore_state(c.state, "latest")
        assert (meta["epoch"], meta["step_in_epoch"], c.state.step) == (0, 2, 2)
        assert c.train_epoch(2)["updates"] == 2
        _assert_identical(_trainable(c), want)
        assert c.state.step == a.state.step == 4

    def test_sigterm_then_resume_equals_an_uninterrupted_fit(self, proc, tmp_path):
        cfg = _cfg(checkpoint_every_steps=2)
        a = _trainer(cfg, proc, tmp_path / "a")
        history_a = a.fit()
        want = _trainable(a)

        b = _trainer(cfg, proc, tmp_path / "b")
        step, calls = b._train_step, []

        def step_then_signal(*args):
            out = step(*args)
            calls.append(1)
            if len(calls) == 3:  # epoch 0, macro step 3 of 4
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        b._train_step = step_then_signal
        assert b.fit() == []  # stopped mid-epoch: no record
        meta = json.loads(open(os.path.join(b.ckpt.dir, "latest.meta.json")).read())
        assert (meta["epoch"], meta["step_in_epoch"]) == (0, 3)

        c = _trainer(cfg, proc, tmp_path / "b")
        history_c = c.fit(resume=True)
        _assert_identical(_trainable(c), want)
        assert c.state.step == a.state.step == 8
        assert [r["updates"] for r in history_c] == [1, 4]
        assert history_c[1]["train_loss"] == history_a[1]["train_loss"]
        assert [r["val_loss"] for r in history_c] == [r["val_loss"] for r in history_a]

    @pytest.mark.parametrize("field, value", [
        ("batch_size", 1), ("accumulation_steps", 1), ("train_stride", 2), ("seed", 9),
    ])
    def test_changed_batch_geometry_is_refused(self, proc, tmp_path, field, value):
        cfg = _cfg()
        a = _trainer(cfg, proc, tmp_path)
        a.train_epoch(0, _StopAfter(1))
        a._save_latest(step_in_epoch=1)
        changed = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **{field: value}))
        with pytest.raises(RuntimeError, match="batch geometry.*" + field):
            _trainer(changed, proc, tmp_path).fit(resume=True)


def test_ema_weights_validate_and_become_the_best(proc, tmp_path):
    """With an EMA, validation and best_params.pt use the averaged weights,
    swapped in for the call and out again."""
    t = _trainer(_cfg(ema_decay=0.9, epochs=1), proc, tmp_path)
    t.fit()
    raw = _trainable(t)
    best = torch.load(t.ckpt.path("best_params"), weights_only=True)
    assert all(torch.equal(best[n], e) for n, e in t.state.ema.items())
    assert any(not torch.equal(raw[n], e) for n, e in t.state.ema.items())
    loss_ema, _ = t.validate()
    _assert_identical(_trainable(t), raw)
    with torch.no_grad():
        for n, p in t.state.trainable().items():
            p.copy_(t.state.ema[n])
    t.state.ema = None
    assert t.validate()[0] == loss_ema


def test_remat_leaves_loss_and_gradients_unchanged():
    """torch.utils.checkpoint around each GPT-2 block, every dropout at 0.1:
    the recompute restores the RNG state, so the masks and the gradients are
    the plain backward's."""
    cfg = _cfg()
    graph = build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w))
    shifts, pair = graph_inputs(graph, "cpu")
    split = synthetic_processed_split(3, cfg.train.L_in, cfg.train.L_out, cfg.model.num_nodes, seed=5)
    batch = {k: torch.from_numpy(v) for k, v in SlidingWindowDataset(split, cfg.train.L_in, cfg.train.L_out)
             .gather_batch(np.arange(3)).items()}
    base = TECMoLLM(cfg.model, shifts, seed=2).state_dict()
    base = {k: v + 0.01 if k.endswith("lora_B.weight") else v for k, v in base.items()}
    out = []
    for remat in (False, True):
        model = TECMoLLM(cfg.model, shifts, remat_llm=remat)
        model.load_state_dict(base)
        model.train()
        torch.manual_seed(11)
        wsum, count = make_sum_loss_fn(model, cfg)(batch, pair)
        (wsum / count).backward()
        out.append((float(wsum.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert loss_a == loss_b
    for n, g in grads_a.items():
        torch.testing.assert_close(grads_b[n], g, rtol=1e-6, atol=1e-9, msg=n)


class TestCLI:
    def _argv(self, data_dir, workdir, *extra):
        cfg_path = os.path.join(workdir, "tiny.json")
        os.makedirs(workdir, exist_ok=True)
        with open(cfg_path, "w") as f:
            f.write(_cfg().to_json())
        return ["--config", cfg_path, "--data-dir", data_dir, "--workdir", workdir, "--run-name", "r",
                "--epochs", "2", "--train-stride", "1", *extra]

    def test_trains_then_serves_best_params(self, proc, tmp_path, capsys):
        workdir = str(tmp_path)
        history = train_cli.main(self._argv(proc, workdir, "--cpu", "--checkpoint-every-steps", "2",
                                            "--profile-dir", str(tmp_path / "prof")))
        run = tmp_path / "checkpoints" / "r"
        assert sorted(os.listdir(run)) == ["best_params.pt", "config.json", "latest.meta.json", "latest.pt"]
        assert (tmp_path / "prof" / "trace.json").exists()
        records = [json.loads(line) for line in open(tmp_path / "logs" / "r.jsonl")]
        assert len(records) == len(history) == 2 and all(np.isfinite(r["train_loss"]) for r in records)
        assert set(records[0]) == {"epoch", "train_loss", "updates", "steps_in_epoch", "windows_per_sec",
                                   "val_loss", "mae_avg", "rmse_avg", "r2_score_avg", "pearson_r_avg"}
        meta = json.loads((run / "latest.meta.json").read_text())
        assert set(meta) == {"epoch", "step_in_epoch", "best_val_loss", "patience_counter", "config",
                             "process_count"}
        assert pcfg.Config.from_json((run / "config.json").read_text()) == _cfg(train_stride=1, checkpoint_every_steps=2)

        no_stencil = _write_processed(str(tmp_path / "proc_padded"), _cfg(), stencil=False)
        capsys.readouterr()
        for data_dir, route in ((proc, "kernel"), (no_stencil, "plain: padded-gather graph (no stencil)")):
            serve_cli.main(["--cpu", "--data-dir", data_dir, "--checkpoint", str(run / "best_params.pt"),
                            "--bench", "2"])
            stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert stats["requests"] == 2 and stats["gat_route"] == route and stats["device"] == "cpu"

    def test_resume_continues_the_run(self, proc, tmp_path):
        first = train_cli.main(self._argv(proc, str(tmp_path), "--cpu", "--epochs", "1"))
        again = train_cli.main(self._argv(proc, str(tmp_path), "--cpu", "--resume"))
        assert [r["epoch"] for r in first] == [0] and [r["epoch"] for r in again] == [1]

    def test_gpt2_checkpoint_is_imported(self, proc, tmp_path):
        """--gpt2-checkpoint overlays an HF GPT-2 state_dict (here the backbone's
        own tensors, perturbed, under HF's ``transformer.`` prefix and without
        LoRA) through Trainer.set_params; the LoRA adapters keep their init."""
        argv = self._argv(proc, str(tmp_path), "--cpu")
        fresh = train_cli.build_trainer(train_cli.parse_args(argv), _cfg(train_stride=1))
        backbone = fresh.model.llm_backbone.model
        hf = {f"transformer.{k}": v + 0.5 for k, v in backbone.state_dict().items() if ".lora_" not in k}
        torch.save(hf, tmp_path / "gpt2.pt")
        args = train_cli.parse_args(argv + ["--gpt2-checkpoint", str(tmp_path / "gpt2.pt")])
        trainer = train_cli.build_trainer(args, train_cli.build_config(args))
        got = trainer.model.llm_backbone.model.state_dict()
        for k, v in got.items():
            want = hf[f"transformer.{k}"] if ".lora_" not in k else backbone.state_dict()[k]
            assert torch.equal(v, want), k

    def test_refuses_without_cuda_unless_cpu(self, proc, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(self._argv(proc, str(tmp_path)))

    @pytest.mark.parametrize("flags, match", [
        (["--multihost"], None),
        (["--model-parallel", "2"], "tensor parallelism"),
        (["--device-data"], "device-resident archive"),
    ])
    def test_refuses_what_is_not_ported(self, proc, tmp_path, flags, match, capsys):
        if flags == ["--device-data"]:
            # ported: the CLI trains on the device-resident archive of a dir the
            # port's preprocess CLI wrote (tests/test_torch_device_data.py holds
            # it to the host path); a dir without *_raw.npz is refused with the
            # command that makes one
            from tec_mollm_tpu_torch.data.preprocess import run_preprocess

            with pytest.raises(FileNotFoundError, match="tec_mollm_tpu_torch.data.preprocess"):
                train_cli.main(self._argv(proc, str(tmp_path / "a"), "--cpu", *flags))
            data = str(tmp_path / "archive")
            run_preprocess(_cfg().data, data, synthetic_steps=300, synthetic_grid=(6, 8))
            capsys.readouterr()
            history = train_cli.main(self._argv(data, str(tmp_path / "b"), "--cpu", *flags))
            assert len(history) == 2 and all(np.isfinite(r["train_loss"]) for r in history)
            assert match in capsys.readouterr().err  # the trainer's log line
            return
        with pytest.raises(SystemExit) as e:
            train_cli.main(self._argv(proc, str(tmp_path), "--cpu", *flags))
        text = str(e.value) if match else capsys.readouterr().err
        assert "ROADMAP Queue A" in text and (match is None or match in text)

    def test_refuses_other_remat_policies(self, proc, tmp_path):
        cfg = _cfg()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat_llm=True, remat_policy="dots_saveable"))
        with pytest.raises(ValueError, match="remat_policy"):
            _trainer(cfg, proc, tmp_path)
        args = train_cli.parse_args(["--remat"])
        assert train_cli.build_config(args).train.remat_llm


class TestServiceRouting:
    def test_general_route_is_reported(self, proc):
        """A config the tiled kernel does not take (1 head x 22 channels)
        serves through the kernel's general form, and stats() and health()
        say why; the flagship layout reports the tiled kernel."""
        cfg = _cfg()
        graph = build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w))
        shifts = tuple(int(s) for s in graph.stencil_shifts)
        for heads, channels, want in ((1, 22, "kernel, general form: "), (2, 11, "kernel")):
            c = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, spatial_heads=heads, spatial_out_channels=channels))
            sd = TECMoLLM(c.model, shifts, seed=1).state_dict()
            service = ForecastService(c, proc, state_dict=sd, batch_window_ms=0, device="cpu")
            try:
                out = service.forecast([0, 1])
                assert np.isfinite(np.asarray(out["forecast"])).all()
                for report in (service.stats(), service.health()):
                    route = report["gat_route"]
                    assert route == want if want == "kernel" else route.startswith(want) and "1x22" in route
            finally:
                service.close()

    def test_opt_in_kernels_refused_on_the_card_before_loading(self, proc, monkeypatch):
        """On CUDA (as far as the service can tell) an fp32 fused MLP is refused
        before any weight or data is read: the empty state_dict is never loaded."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="bf16"):
            ForecastService(_cfg(), proc, state_dict={}, use_fused_mlp=True, device="cuda")
