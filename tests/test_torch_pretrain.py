"""PyTorch port: the surrogate GPT-2 pretraining path against the JAX package's.

A tiny byte LM (d 32, 4 heads, 2 blocks, no LoRA) is initialised in JAX, every
parameter is redrawn from a numpy seed, and the same tree goes into the port
through ``byte_lm_params_to_state_dict``. The sequence is T = 129 (seq_len
128 + 1), so the port's flash route is taken; on the CPU it computes the plain
version, which in fp32 is JAX's einsum attention. All fp32 on the CPU.

Tolerances: logits to 1e-5 (fp32 sums in another order); losses to 1e-5
relative; parameters after AdamW to 2e-6 absolute per update at lr 1e-3,
except at most 1 element in 10^4, held to 2 * lr per update (Adam divides each
gradient by its own magnitude, so gradients at fp32 noise level may step
differently: the allowance of the forecast model's step test). The key bias,
whose true gradient is 0 (the softmax cancels it), steps on noise on both
sides and is held to the 2 * lr bound only. Schedules to
1e-6 of the peak (optax evaluates in fp32). Corpus, batches and checkpoint
tensors exactly."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.synthetic import grid_coordinates
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.models import byte_lm as jlm
from tec_mollm_tpu.models import hf_export as jexport
from tec_mollm_tpu.models import hf_import as jimport
from tec_mollm_tpu.models.gpt2 import GPT2Backbone as JaxBackbone
from tec_mollm_tpu_torch import pretrain as pretrain_cli
from tec_mollm_tpu_torch.models import ByteLM, TECMoLLM, byte_lm_params_to_state_dict, graph_inputs
from tec_mollm_tpu_torch.models import byte_lm as plm
from tec_mollm_tpu_torch.models import gpt2
from tec_mollm_tpu_torch.models.hf_export import backbone_state_dict_to_hf, save_hf_checkpoint
from tec_mollm_tpu_torch.models.hf_import import load_gpt2_into_model, load_torch_checkpoint, normalize_keys
from tec_mollm_tpu_torch.training import create_pretrain_state, make_pretrain_step, warmup_cosine_decay

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = dict(d_llm=32, llm_heads=4, llm_layers=2)
SEQ = 128
LR, PARAM_ATOL = 1e-3, 2e-6


def _lm_configs(**over):
    return [m.pretrain_model_config(dataclasses.replace(c.ModelConfig(**WIDTHS), **over)) for m, c in ((jlm, jcfg), (plm, pcfg))]


def _corpus(n=40_000, seed=0):
    return np.random.default_rng(seed).integers(32, 127, size=n, dtype=np.uint8).tobytes()


def _tokens(b=2, t=SEQ + 1, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t)).astype(np.int32)


def _redraw(params, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_dict(jax.device_get(params), sep="/").items():
        scale = k.endswith("/scale")
        out[k] = ((1.0 if scale else 0.0) + 0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
    return out


class World:
    """One tiny byte LM with redrawn parameters on both sides."""

    def __init__(self, **over):
        self.jc, self.pc = _lm_configs(**over)
        self.jmodel = jlm.ByteLM(self.jc)
        init = self.jmodel.init(jax.random.key(0), jnp.asarray(_tokens()))["params"]
        self.flat = _redraw(init)
        self.params = unflatten_dict(self.flat, sep="/")

    def port(self, use_flash=True):
        model = ByteLM(self.pc, use_flash=use_flash)
        model.load_state_dict(byte_lm_params_to_state_dict(self.flat, self.pc))
        return model


@pytest.fixture(scope="module")
def world():
    return World()


class TestCorpusAndBatches:
    def test_gather_text_corpus_equals_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        files = ["a.py", "b.md", "c.txt", "d.rst", "skip.bin", "sub/e.py", "sub/deeper/f.md",
                 "__pycache__/g.py", ".hidden/h.py", "sub/big.txt", "z/zz.py"]
        for i, name in enumerate(files):
            path = tmp_path / name
            path.parent.mkdir(parents=True, exist_ok=True)
            size = 3000 if name == "sub/big.txt" else 200 + i
            path.write_bytes(rng.integers(32, 127, size=size, dtype=np.uint8).tobytes())
        roots = [str(tmp_path / "sub"), str(tmp_path)]
        for kwargs in ({}, {"max_bytes": 2500}, {"max_file_bytes": 500}, {"extensions": (".md",)}):
            got = plm.gather_text_corpus(roots, **kwargs)
            assert got == jlm.gather_text_corpus(roots, **kwargs), kwargs
            assert got
        assert b"\x00" not in plm.gather_text_corpus([str(tmp_path)])

    @pytest.mark.parametrize("batch,seq,seed", [(4, SEQ, 0), (1, 16, 7), (64, 32, 3)])
    def test_byte_batches_equal_jax(self, batch, seq, seed):
        corpus = _corpus()
        mine, want = plm.byte_batches(corpus, batch, seq, seed), jlm.byte_batches(corpus, batch, seq, seed)
        np.testing.assert_array_equal(mine[1], want[1])
        assert mine[1].dtype == np.int32 and mine[1].shape == (batch, seq + 1)
        for _ in range(3):
            np.testing.assert_array_equal(next(mine[0]), next(want[0]))

    def test_too_small_corpus_is_refused_as_in_jax(self):
        with pytest.raises(ValueError, match="too small"):
            jlm.byte_batches(_corpus(500), 4, SEQ)
        with pytest.raises(ValueError, match="too small"):
            plm.byte_batches(_corpus(500), 4, SEQ)

    def test_next_byte_loss(self):
        rng = np.random.default_rng(1)
        logits = (3 * rng.normal(size=(3, 17, 256))).astype(np.float32)
        tokens = _tokens(3, 17)
        got = plm.next_byte_loss(torch.from_numpy(logits), torch.from_numpy(tokens))
        want = jlm.next_byte_loss(jnp.asarray(logits), jnp.asarray(tokens))
        assert float(got) == pytest.approx(float(want), rel=1e-6)


class TestByteLM:
    @pytest.mark.parametrize("use_flash", [True, False])
    def test_forward_matches_jax_at_t129(self, world, monkeypatch, use_flash):
        calls = []

        def spy(*args, **kwargs):
            calls.append(args[0].shape[1])
            return plm_flash(*args, **kwargs)

        plm_flash = gpt2.flash_attention
        monkeypatch.setattr(gpt2, "flash_attention", spy)
        tokens = _tokens()
        want = world.jmodel.apply({"params": world.params}, jnp.asarray(tokens), deterministic=True)
        model = world.port(use_flash).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(tokens))
        assert got.dtype == torch.float32 and got.shape == (2, SEQ + 1, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        assert calls == ([SEQ + 1] * WIDTHS["llm_layers"] if use_flash else [])

    def test_state_dict_names(self, world):
        sd = world.port().state_dict()
        assert "wte" in sd and "backbone.h.1.attn.c_attn.weight" in sd
        assert not any("lora" in k for k in sd)
        assert set(sd) == set(byte_lm_params_to_state_dict(world.flat, world.pc))


class TestSchedule:
    @pytest.mark.parametrize(
        "init,peak,warmup,decay,end",
        [(0.0, 3e-4, 100, 3000, 3e-6), (0.0, LR, 2, 5, LR * 0.01), (1e-5, 1.0, 10, 11, 0.0)],
    )
    def test_warmup_cosine_decay_equals_optax(self, init, peak, warmup, decay, end):
        ours = warmup_cosine_decay(init, peak, warmup, decay, end)
        steps = np.arange(decay + 20)
        want = np.asarray(optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)(jnp.asarray(steps)))
        got = np.array([ours(s) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)
        assert got[0] == init and got[warmup] == pytest.approx(peak)

    def test_decay_must_exceed_warmup(self):
        with pytest.raises(ValueError):
            warmup_cosine_decay(0.0, 1.0, 5, 5)


class TestPretrainStep:
    def test_five_steps_match_the_jax_step(self):
        """The step of ``scripts/pretrain_backbone.py:119-131`` in fp32 with
        every dropout at 0: clip by global norm 1.0, AdamW wd 0.01 over every
        parameter, warm-up from 0 (the first update has lr 0)."""
        w = World(llm_dropout=0.0)
        warmup, steps = 2, 5
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, steps, LR * 0.01)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.01))

        @jax.jit
        def jstep(params, opt_state, tokens):
            def loss_fn(p):
                logits = w.jmodel.apply({"params": p}, tokens, deterministic=False, rngs={"dropout": jax.random.key(1)})
                return jlm.next_byte_loss(logits, tokens)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        batches, _ = plm.byte_batches(_corpus(), 4, SEQ, seed=0)
        data = [next(batches) for _ in range(steps)]
        params, opt_state, jlosses = w.params, tx.init(w.params), []
        for tokens in data:
            params, opt_state, loss = jstep(params, opt_state, jnp.asarray(tokens))
            jlosses.append(float(loss))

        model = w.port(use_flash=True)
        state = create_pretrain_state(model, seed=0)
        step = make_pretrain_step(warmup_cosine_decay(0.0, LR, warmup, steps, LR * 0.01))
        losses = [float(step(state, torch.from_numpy(tokens))["loss"]) for tokens in data]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert state.step == steps

        want = byte_lm_params_to_state_dict(flatten_dict(jax.device_get(params), sep="/"), w.pc)
        got = model.state_dict()
        diffs = {n: (got[n] - want[n]).abs().numpy() for n in want}
        for name, d in diffs.items():
            assert d.max() <= 2 * LR * steps, (name, d.max())
        # The key bias adds q.b_k to every score of a row, which the softmax
        # cancels: its true gradient is 0 and both sides step on fp32 noise
        # there, so it is held to the 2 * lr bound above only.
        d_model = WIDTHS["d_llm"]
        for name in diffs:
            if name.endswith("attn.c_attn.bias"):
                diffs[name] = np.delete(diffs[name], np.s_[d_model:2 * d_model])
        outliers = sum(int((d > steps * PARAM_ATOL).sum()) for d in diffs.values())
        assert outliers <= 1e-4 * sum(d.size for d in diffs.values()), outliers
        moved = byte_lm_params_to_state_dict(w.flat, w.pc)
        assert all(not torch.equal(got[n], moved[n]) for n in got)  # wd moves every tensor


def _tiny_forecast(lora_r=4):
    """The JAX and port tiny forecast configs at the byte LM's widths."""
    out = []
    for mod in (jcfg, pcfg):
        c = mod.tiny_config(**WIDTHS)
        out.append(dataclasses.replace(c.model, lora_r=lora_r, lora_dropout=0.0, llm_dropout=0.0))
    return out


class TestHFCheckpoints:
    def test_port_export_loads_through_jax_import(self, world, tmp_path):
        """The port's export of the byte LM is, key for key and bit for bit,
        JAX's export of the same tree, and JAX's importer reads it back to the
        same arrays."""
        model = world.port()
        sd = backbone_state_dict_to_hf(model.backbone, wte=model.wte)
        want = jexport.backbone_params_to_state_dict(world.params["backbone"], WIDTHS["llm_layers"], wte=world.params["wte"])
        assert list(sd) == list(want)
        for k, v in want.items():
            assert sd[k].dtype == torch.float32
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)

        meta = {"surrogate": "byte-lm", "steps": 3}
        save_hf_checkpoint(sd, str(tmp_path / "port"), meta=meta)
        jexport.save_hf_checkpoint(want, str(tmp_path / "jax"), meta=meta)
        configs = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("port", "jax")]
        assert configs[0] == configs[1] and configs[0]["vocab_size"] == 256
        loaded = jimport.load_torch_checkpoint(str(tmp_path / "port"))
        imported = flatten_dict(jimport.gpt2_state_dict_to_params(loaded, world.jc), sep="/")
        original = flatten_dict(world.params["backbone"], sep="/")
        assert set(imported) == set(original)
        for k, v in original.items():
            np.testing.assert_array_equal(imported[k], v, err_msg=k)

    @pytest.mark.parametrize("adapters", [False, True])
    def test_jax_export_loads_through_port_import(self, world, tmp_path, adapters):
        """A JAX export (plus, in peft's layout and key names, LoRA adapters)
        loads into a tiny LoRA TECMoLLM; its backbone output equals the JAX
        forecast model's backbone after ``load_gpt2_into_model_params``."""
        sd = jexport.backbone_params_to_state_dict(world.params["backbone"], WIDTHS["llm_layers"], wte=world.params["wte"])
        jm, pm = _tiny_forecast()
        rng = np.random.default_rng(9)
        if adapters:
            for i in range(WIDTHS["llm_layers"]):
                key = f"base_model.model.h.{i}.attn.c_attn"
                sd[f"{key}.lora_A.default.weight"] = (0.1 * rng.normal(size=(jm.lora_r, 32))).astype(np.float32)
                sd[f"{key}.lora_B.default.weight"] = (0.1 * rng.normal(size=(96, jm.lora_r))).astype(np.float32)
        jexport.save_hf_checkpoint(sd, str(tmp_path))

        graph = build_graph(*grid_coordinates(jm.grid_h, jm.grid_w))
        shifts = tuple(int(s) for s in graph.stencil_shifts)
        model = TECMoLLM(pm, shifts, seed=1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = load_torch_checkpoint(str(tmp_path))
        assert all(isinstance(v, torch.Tensor) for v in loaded.values())
        load_gpt2_into_model(model, loaded)
        after = model.state_dict()
        norm = normalize_keys(loaded)
        prefix = "llm_backbone.model."
        for name, v in after.items():
            key = name[len(prefix):]
            if not name.startswith(prefix):
                assert torch.equal(v, before[name]), name  # nothing outside the backbone moves
            elif ".lora_" in name and not adapters:
                assert torch.equal(v, before[name]), name  # fresh init kept
            else:
                want = norm[key][: v.shape[0]] if key == "wpe.weight" else norm[key]
                assert torch.equal(v, want), name
        if not adapters:
            assert all(not after[n].any() for n in after if n.endswith("lora_B.weight"))

        # the JAX forecast model's backbone (its "llm" subtree, lean LN as in
        # TECMoLLM) with a fresh LoRA init, overlaid by the JAX importer
        embeds = np.random.default_rng(4).normal(size=(3, 5, 32)).astype(np.float32)
        backbone = JaxBackbone(jm, lean_ln=True)
        init = {"llm": backbone.init(jax.random.key(0), jnp.asarray(embeds))["params"]}
        merged = jimport.load_gpt2_into_model_params(init, jimport.load_torch_checkpoint(str(tmp_path)), jm)
        want = backbone.apply({"params": merged["llm"]}, jnp.asarray(embeds), True)
        with torch.no_grad():
            got = model.eval().llm_backbone(torch.from_numpy(embeds))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    def test_normalize_keys_equals_jax(self):
        keys = ["module.base_model.model.transformer.h.0.attn.c_attn.base_layer.weight",
                "base_model.model.h.0.attn.c_attn.lora_A.default.weight", "_orig_mod.wpe.weight",
                "module.module.ln_f.bias", "h.1.mlp.c_fc.bias"]
        sd = {k: np.full((2,), i, np.float32) for i, k in enumerate(keys)}
        got, want = normalize_keys(sd), jimport.normalize_keys(sd)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])

    def test_load_torch_checkpoint_paths(self, world, tmp_path):
        sd = backbone_state_dict_to_hf(world.port().backbone)
        torch.save(sd, tmp_path / "w.pt")
        for path in (tmp_path / "w.pt", Path(save_hf_checkpoint(sd, str(tmp_path / "d"))).parent):
            got = load_torch_checkpoint(str(path))
            assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError):
            load_torch_checkpoint(str(tmp_path / "empty"))

    def test_export_refuses_lora_and_import_checks_shapes(self, tmp_path):
        jm, pm = _tiny_forecast()
        graph = build_graph(*grid_coordinates(pm.grid_h, pm.grid_w))
        model = TECMoLLM(pm, tuple(int(s) for s in graph.stencil_shifts))
        with pytest.raises(ValueError, match="LoRA"):
            backbone_state_dict_to_hf(model.llm_backbone.model)
        narrow = backbone_state_dict_to_hf(ByteLM(plm.pretrain_model_config(pcfg.ModelConfig(d_llm=16, llm_heads=4, llm_layers=2))).backbone)
        with pytest.raises(ValueError, match="shape mismatch"):
            load_gpt2_into_model(model, narrow)
        fits = backbone_state_dict_to_hf(ByteLM(plm.pretrain_model_config(pm)).backbone)
        with pytest.raises(KeyError, match="ln_f"):
            load_gpt2_into_model(model, {k: v for k, v in fits.items() if not k.startswith("ln_f")})


class TestCLI:
    def test_cpu_run_writes_the_checkpoint_that_the_importer_reads(self, tmp_path):
        corpus = tmp_path / "corpus"
        corpus.mkdir()
        for i in range(4):
            (corpus / f"f{i}.txt").write_bytes(_corpus(8000, seed=i))
        out = tmp_path / "ckpt"
        cmd = [sys.executable, "-m", "tec_mollm_tpu_torch.pretrain", "--cpu", "--out", str(out),
               "--steps", "3", "--warmup", "1", "--batch-size", "2", "--seq-len", str(SEQ),
               "--d-llm", "32", "--llm-layers", "2", "--llm-heads", "4", "--log-every", "1",
               "--corpus-roots", str(corpus)]
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr
        assert "step 3/3" in run.stderr
        assert sorted(os.listdir(out)) == ["config.json", "pretrain_meta.json", "pytorch_model.bin"]
        meta = json.loads((out / "pretrain_meta.json").read_text())
        assert meta["steps"] == 3 and meta["seq_len"] == SEQ and meta["batch_size"] == 2
        assert np.isfinite(meta["val_loss_final"]) and meta["val_loss_initial"] == pytest.approx(np.log(256), rel=0.2)
        config = json.loads((out / "config.json").read_text())
        assert (config["n_embd"], config["n_layer"], config["vocab_size"]) == (32, 2, 256)
        _, pm = _tiny_forecast()
        graph = build_graph(*grid_coordinates(pm.grid_h, pm.grid_w))
        model = TECMoLLM(pm, tuple(int(s) for s in graph.stencil_shifts))
        load_gpt2_into_model(model, load_torch_checkpoint(str(out)))
        _, graph_pair = graph_inputs(graph, "cpu")
        x = torch.zeros(1, pm.temporal_seq_len, pm.num_nodes, pm.in_features)
        tf = torch.zeros(1, pm.temporal_seq_len, 4, dtype=torch.int32)
        with torch.no_grad():
            assert torch.isfinite(model.eval()(x, tf, *graph_pair)).all()

    def test_without_cpu_and_without_cuda_it_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pretrain_cli.main(["--steps", "1"])
