"""PyTorch port: TEC-MoLLM on a DeepSeek-V2 backbone (``models/deepseek_v2.py``),
on the CPU in float32 at a tiny size (d 64, 4 heads, nope/rope/v 16/8/16, kv
rank 32, 8 experts of width 32, top-2, 1 shared, 3 layers: one dense, two MoE).

Held to the benchmark's plain reference (``benchmark/reference/deepseek_v2.py``)
on its seeded weights: the backbone and the whole forward (identical top-k
choices, outputs within 1e-5 relative), one Trainer step's loss and LoRA and
RMSNorm gradients against the reference's autograd; YaRN's frequencies and the
softmax scale against their closed forms at the published sizes; the device
dispatch's layout; the trainable set; the refusals; the spans and counters; and
the train, test and serve CLIs on a JSON config."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
from test_torch_trainer import NO_DROPOUT, _write_processed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import tec_mollm_tpu_torch.config as pcfg
from benchmark.reference import deepseek_v2 as rd
from benchmark.reference import model as ref
from tec_mollm_tpu_torch import serve as serve_cli
from tec_mollm_tpu_torch import test as test_cli
from tec_mollm_tpu_torch import train as train_cli
from tec_mollm_tpu_torch.data import SlidingWindowDataset
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.models import deepseek_v2 as dsv2
from tec_mollm_tpu_torch.models.tec_mollm import opt_in_kernel_refusal
from tec_mollm_tpu_torch.parallel.tensor_parallel import model_plan, shard_model_
from tec_mollm_tpu_torch.training.optimizer import trainable_mask
from tec_mollm_tpu_torch.training.trainer import Trainer
from tec_mollm_tpu_torch.utils import profiler

TINY_DS = pcfg.DeepSeekV2Config(
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
)
PUBLISHED = pcfg.DeepSeekV2Config()


def _cfg(dropout=True, ds=TINY_DS, **train) -> pcfg.Config:
    c = pcfg.tiny_config(llm_layers=3)
    model = dataclasses.replace(c.model, deepseek_v2=ds, **{**({} if dropout else NO_DROPOUT), "llm_dropout": 0.0})
    train = dataclasses.replace(c.train, **{"bf16": False, "epochs": 1, **train})
    return dataclasses.replace(c, model=model, train=train).resolved()


def _ref_config(cfg: pcfg.Config) -> dict:
    """The reference's configuration dict of a port config, its grid as the
    benchmark lays one out."""
    raw = json.loads(cfg.to_json())
    raw["grid"] = {"lat0_deg": 10.0, "lon0_deg": 70.0, "step_deg": 1.0}
    return raw


def _weights(dims: rd.Dims, seed: int = 3) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(shape, generator=g) * std + mean for n, shape, mean, std in rd.specs(dims)}


def _model(cfg, params=None, **kw):
    shifts, graph = graph_inputs(build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w)), "cpu")
    model = TECMoLLM(cfg.model, shifts, seed=None if params is not None else 0, **kw)
    if params is not None:
        model.load_state_dict(params)
    return model, graph


def _inputs(cfg, b=3, seed=0):
    g = np.random.default_rng(seed)
    m = cfg.model
    x = torch.as_tensor(g.standard_normal((b, cfg.train.L_in, m.num_nodes, m.in_features)), dtype=torch.float32)
    tf = torch.as_tensor(np.stack([g.integers(0, v, (b, cfg.train.L_in)) for v in (12, 366, 13, 4)], -1))
    return x, tf


def _record_routes(model) -> list:
    routes = []
    for m in model.modules():
        if isinstance(m, dsv2.MoEGate):
            m.register_forward_hook(lambda mod, args, out: routes.append(out[1]))
    return routes


def _same_choices(got: list, want: list) -> None:
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert torch.equal(a.sort(dim=-1).values, b.sort(dim=-1).values)


def test_backbone_matches_the_reference():
    cfg = _cfg()
    dims = rd.Dims.of(_ref_config(cfg))
    params = _weights(dims)
    model, _ = _model(cfg, params)
    model.eval()
    x = torch.randn(40, 3, cfg.model.d_llm, generator=torch.Generator().manual_seed(1))
    routes = _record_routes(model)
    with torch.no_grad():
        got = model.llm_backbone(x)
        want_routes = []
        want = rd.backbone(params, x, dims, ref.Precision(), want_routes)
    _same_choices(routes, want_routes)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_forward_matches_the_reference():
    cfg = _cfg()
    rc = _ref_config(cfg)
    dims = rd.Dims.of(rc)
    params = _weights(dims)
    model, graph = _model(cfg, params)
    model.eval()
    x, tf = _inputs(cfg)
    routes = _record_routes(model)
    with torch.no_grad():
        got = model(x, tf, *graph)
        want_routes = []
        want = rd.forward(params, x, tf, ref.Graph(rc, "cpu"), dims, ref.Precision(), want_routes)
        fp8 = rd.forward(params, x, tf, ref.Graph(rc, "cpu"), dims, ref.Precision(fp8=True))
    _same_choices(routes, want_routes)
    assert got.shape == want.shape == (3, cfg.train.L_out, cfg.model.num_nodes, 1)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (fp8 - want).abs().max() > 100 * (got - want).abs().max()


def test_specs_are_the_program_state_dict():
    cfg = _cfg()
    with torch.device("meta"):
        model = TECMoLLM(cfg.model, (0, 1), seed=None)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: s for n, s, _, _ in rd.specs(rd.Dims.of(_ref_config(cfg)))} == want


def test_yarn_frequencies_and_scale_in_closed_form():
    """At DeepSeek-V2-Lite's published sizes: correction dims floor(10.47) = 10
    and ceil(22.51) = 23, theta^(-2i/64) below, a 40th of it above, a linear
    blend between; scale 192^-1/2 m^2 with m = 0.1 x 0.707 x ln 40 + 1; cos and
    sin unscaled (mscale = mscale_all_dim)."""
    got = dsv2.yarn_inv_freq(PUBLISHED).double()
    i = torch.arange(32, dtype=torch.float64)
    base = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    assert 64 * math.log(4096 / (2 * math.pi * 32)) / (2 * math.log(10000)) == pytest.approx(10.47, abs=0.01)
    assert 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(10000)) == pytest.approx(22.51, abs=0.01)
    torch.testing.assert_close(got, base * (1 - ramp) + base / 40 * ramp, rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:11], base[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[23:], base[23:] / 40, rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert dsv2.softmax_scale(PUBLISHED) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    cos, sin = dsv2.rotary(PUBLISHED, dsv2.yarn_inv_freq(PUBLISHED), 3, torch.float32)
    torch.testing.assert_close(cos[:, 0, :32].double(), torch.cos(torch.arange(3.0)[:, None].double() * got),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sin[:, 0, 32:].double(), torch.sin(torch.arange(3.0)[:, None].double() * got),
                               rtol=1e-6, atol=1e-6)


def test_rotary_is_interleaved():
    """Pair (2i, 2i + 1) turns by angle i: the first half of the output holds
    each pair's first value, the second half its second."""
    x = torch.randn(1, 2, 1, 8)
    angles = torch.tensor([0.3, 0.7, 1.1, 1.9])
    cos, sin = torch.cat([angles, angles]).cos()[None, None], torch.cat([angles, angles]).sin()[None, None]
    out = dsv2.apply_rotary(x, cos, sin)
    even, odd = x[..., 0::2], x[..., 1::2]
    torch.testing.assert_close(out[..., :4], even * angles.cos() - odd * angles.sin())
    torch.testing.assert_close(out[..., 4:], odd * angles.cos() + even * angles.sin())


@pytest.mark.parametrize("m,k,experts", [(1, 1, 1), (37, 2, 8), (256, 6, 64)])
def test_dispatch_groups_every_row_once_in_aligned_groups(m, k, experts):
    g = torch.Generator().manual_seed(m)
    idx = torch.stack([torch.randperm(experts, generator=g)[:k] for _ in range(m)])
    rows, pos, offs, counts = dsv2.dispatch_plan(idx, experts)
    r = m * k
    assert rows.numel() % dsv2.ALIGN == 0 and int(offs[-1]) == rows.numel()
    assert torch.equal(counts, torch.bincount(idx.reshape(-1), minlength=experts))
    assert (offs[:-1] % dsv2.ALIGN == 0).all() and (offs.diff() >= 0).all()
    assert torch.equal(rows[pos], torch.arange(r))                     # every row placed once
    assert int((rows == r).sum()) == rows.numel() - r                  # the rest is padding
    starts = torch.cat([torch.zeros(1, dtype=torch.int64), offs[:-1].long()])
    for e in range(experts):
        group = rows[starts[e]:offs[e]]
        real = group[group < r]
        assert (idx.reshape(-1)[real] == e).all() and len(real) == int(counts[e])
        assert (group[: len(real)] < r).all()                          # real rows first, then padding


def test_trainer_step_matches_the_reference_autograd(tmp_path):
    """One macro step (B 2 x 2, dropout off, no clipping) of the Trainer: its
    loss, and the gradient of every trainable backbone tensor (LoRA and
    RMSNorm), against the reference's loss and autograd on the same rows."""
    cfg = _cfg(dropout=False, clip_grad_norm=1e9)
    proc = _write_processed(str(tmp_path / "proc"), cfg)
    t = cfg.train
    ds = SlidingWindowDataset.from_dir(proc, "train", t.L_in, t.L_out, stride=1)
    trainer = Trainer(cfg, ds, None, GraphData.load(os.path.join(proc, "graph.npz")), None,
                      workdir=str(tmp_path), run_name="r", device="cpu")
    rc = _ref_config(cfg)
    dims = rd.Dims.of(rc)
    params = _weights(dims)
    trainer.set_params(params)
    batch = next(iter(trainer.train_loader.iter_from(0)))
    _, out = trainer._train_step(trainer.state, trainer._put(batch), trainer.graph)
    grads = {n: p.grad for n, p in trainer.state.trainable().items()}

    ref_params = {k: v.clone().requires_grad_(rd.trainable(k)) for k, v in params.items()}
    x, tf, y = (torch.as_tensor(batch[k]) for k in ("x", "time_features", "y"))
    pred = rd.forward(ref_params, x, tf.long(), ref.Graph(rc, "cpu"), dims, ref.Precision())
    err = (pred - y.transpose(1, 2)[..., None]).abs()
    quad = err.clamp(max=t.huber_delta)
    want_loss = (0.5 * quad * quad + t.huber_delta * (err - quad)).mean()
    want_loss.backward()

    assert float(out["loss"]) == pytest.approx(float(want_loss.detach()), rel=1e-5)
    backbone = [n for n in grads if "llm_backbone" in n]
    assert {n.split(".")[-2] for n in backbone} == {"lora_A", "lora_B", "input_layernorm", "post_attention_layernorm",
                                                    "kv_a_layernorm", "norm"}
    for name in backbone:
        want = ref_params[name].grad
        assert (grads[name] - want).abs().max() <= 1e-4 * want.abs().max(), name


def test_the_trainable_set_is_lora_and_rmsnorm():
    cfg = _cfg()
    model, _ = _model(cfg)
    mask = trainable_mask(model)
    inside = {n for n, on in mask.items() if on and "llm_backbone" in n}
    tokens = {n.split(".")[-2] for n in inside}
    assert tokens == {"lora_A", "lora_B", "input_layernorm", "post_attention_layernorm", "kv_a_layernorm", "norm"}
    assert all(mask[n] for n in mask if "llm_backbone" not in n)
    assert mask == {n: rd.trainable(n) for n in mask}
    frozen = [n for n in mask if not mask[n]]
    assert any(".mlp.experts." in n for n in frozen) and any(".mlp.gate." in n for n in frozen)


def test_refusals():
    cfg = _cfg()
    assert "neither opt-in kernel" in opt_in_kernel_refusal(cfg.model, torch.bfloat16, True, False)
    assert "neither opt-in kernel" in opt_in_kernel_refusal(cfg.model, torch.bfloat16, False, True)
    assert opt_in_kernel_refusal(cfg.model, torch.bfloat16, False, False) is None
    for kw in ({"fused_attn": True}, {"use_fused_mlp": True}, {"use_flash": True}, {"remat_llm": True}):
        with pytest.raises(ValueError, match="DeepSeek-V2 backbone takes none of"):
            _model(cfg, **kw)
    model, _ = _model(cfg)
    with pytest.raises(ValueError, match="no tensor-parallel form"):
        shard_model_(model, 0, 2)
    with pytest.raises(ValueError, match="no tensor-parallel form"):
        model_plan(cfg.model, 2)
    from tec_mollm_tpu_torch.serving.export import export_forecaster

    graph = build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w))
    with pytest.raises(ValueError, match="GPT-2 backbone only"):
        export_forecaster(cfg, model.state_dict(), graph, platforms=("cpu",))


def test_presets_write_no_backbone_group_and_a_config_file_round_trips(tmp_path):
    for name, make in pcfg.PRESETS.items():
        c = make()
        assert "deepseek_v2" not in c.to_json(), name
        raw = dataclasses.asdict(c)
        del raw["model"]["deepseek_v2"]
        assert json.loads(c.to_json()) == json.loads(json.dumps(raw)), name
    cfg = _cfg()
    path = tmp_path / "dsv2.json"
    path.write_text(cfg.to_json())
    assert pcfg.load_config(str(path)) == cfg
    with pytest.raises(KeyError, match="no_such"):
        pcfg.Config.from_dict({"model": {"deepseek_v2": {"no_such": 1}}})


def test_the_benchmark_configuration_is_the_published_widths():
    with open(os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs", "dsv2_lite.json")) as f:
        raw = json.load(f)
    cfg = pcfg.Config.from_dict({k: raw[k] for k in ("model", "train", "data")}).resolved()
    ds = cfg.model.deepseek_v2
    assert ds == PUBLISHED
    assert (cfg.model.d_llm, cfg.model.llm_heads, cfg.model.llm_layers) == (raw["hidden_size"], raw["num_attention_heads"],
                                                                            raw["num_hidden_layers"])
    for key in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "intermediate_size",
                "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
                "first_k_dense_replace", "rms_norm_eps", "rope_theta"):
        assert getattr(ds, key) == raw[key], key
    assert raw["norm_topk_prob"] is False and raw["routed_scaling_factor"] == 1   # the gate's fixed form
    rope = raw["rope_scaling"]
    assert (ds.rope_factor, ds.rope_original_max_position_embeddings, ds.rope_beta_fast, ds.rope_beta_slow,
            ds.rope_mscale, ds.rope_mscale_all_dim) == (rope["factor"], rope["original_max_position_embeddings"],
                                                        rope["beta_fast"], rope["beta_slow"], rope["mscale"],
                                                        rope["mscale_all_dim"])
    assert raw["q_lora_rank"] is None and raw["topk_method"] == "greedy" and raw["scoring_func"] == "softmax"


class _NoHostRead:
    """Raises on every way a tensor reaches the host from Python while active."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def f(*a, **k):
                raise AssertionError(f"host read: Tensor.{name}")
            return f

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def test_untraced_backbone_reads_nothing_back_and_traced_counts():
    cfg = _cfg()
    model, _ = _model(cfg)
    model.eval()
    x = torch.randn(10, 3, cfg.model.d_llm)
    with torch.no_grad(), _NoHostRead():
        model.llm_backbone(x)
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.llm_backbone(x)
    rec = profiler.recorded()
    stats, counts = rec["stats"], rec["counts"]
    assert stats["llm.mla.attention"]["count"] == 3
    for name in ("llm.moe.route", "llm.moe.dispatch", "llm.moe.experts", "llm.moe.combine"):
        assert stats[name]["count"] == 2, name
    assert counts["llm.moe.calls"] == 2 and counts["llm.moe.rows"] == 2 * 30 * 2
    assert 30 * 2 / 8 <= counts["llm.moe.rows_max"] / 2 <= 30
    assert counts["llm.dense.epilogue"] == 3 * 2                     # q_proj and kv_a, each layer


def test_cli_trains_scores_and_serves_a_json_config(tmp_path, capsys):
    """The train CLI on the config file, then the test CLI's scoring loop
    (``EvalExecutor``) and the serve CLI (``ForecastService``) on its run."""
    cfg = _cfg()
    proc = _write_processed(str(tmp_path / "proc"), cfg)
    path = tmp_path / "dsv2.json"
    path.write_text(cfg.to_json())
    work = str(tmp_path / "w")
    train_cli.main(["--cpu", "--config", str(path), "--data-dir", proc, "--workdir", work, "--run-name", "ds",
                    "--epochs", "1"])
    run = os.path.join(work, "checkpoints", "ds")
    assert os.path.exists(os.path.join(run, "best_params.pt"))
    test_cli.main(["--cpu", "--data-dir", proc, "--workdir", work, "--checkpoint", "latest",
                   "--output-dir", str(tmp_path / "results")])
    assert os.path.exists(tmp_path / "results" / "evaluation_results.csv")
    capsys.readouterr()
    serve_cli.main(["--cpu", "--data-dir", proc, "--workdir", work, "--bench", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["requests"], out["device"]) == (2, "cpu")
