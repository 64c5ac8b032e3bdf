"""The DeepSeek-V2 cell (``dsv2_lite-forecast``) on the CPU at ``tiny.json``'s
sizes: its reference against the program, its counts against the program's
products, its readers, and the planted faults that must turn ``correct``
false."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, counts_moe, harness, spec
from benchmark.drivers import forecast_moe
from benchmark.reference import deepseek_v2 as rd

CELL = "dsv2_lite-forecast"
SEED = 2**31 + 20260417


def merged(tiny: dict) -> dict:
    return harness.merge(spec.config("dsv2_lite"), tiny["config"])


def run(tiny, trace=False):
    return harness.run_cell(CELL, SEED, 0.5, trace, device="cpu", overrides=tiny, log=lambda *a, **k: None)


def test_specs_are_the_program_state_dict():
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM

    cfg = spec.config("dsv2_lite")
    conf = Config.from_dict({k: cfg[k] for k in ("model", "train", "data")}).resolved()
    with torch.device("meta"):
        model = TECMoLLM(conf.model, (0, 1), seed=None)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: s for n, s, _, _ in rd.specs(rd.Dims.of(cfg))} == want


def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[-1]


def test_forward_flops_count_the_program_products(tiny):
    """The program's products at the tiny size against the count: every
    routed row takes its k experts' three products. The grouped products run
    over the dispatch buffer, whose zero padding rows (each expert's group
    rounded up to 16, at most 15 rows an expert) are the program's own work,
    and the attention over T tokens is left out of the count."""
    from benchmark.tests.test_bench_reference import program_model
    from tec_mollm_tpu_torch.models.deepseek_v2 import ALIGN

    cfg = merged(tiny)
    model, graph = program_model(cfg)
    model.eval()
    dims = rd.Dims.of(cfg)
    b = dims.base
    x = torch.zeros(2, b.l_in, b.n, b.c_raw)
    tf = torch.zeros(2, b.l_in, 4, dtype=torch.long)
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten._grouped_mm: _grouped_mm_flops}) as fc, \
            torch.no_grad():
        model(x, tf, *graph)
    rows = 2 * b.n * b.tokens * dims.top_k
    buffer = -(-(rows + dims.experts * (ALIGN - 1)) // ALIGN) * ALIGN
    moe_layers = sum(dims.moe(i) for i in range(b.layers))
    padding = moe_layers * 3 * 2.0 * (buffer - rows) * b.d * dims.moe_inter
    attention = b.layers * 2.0 * (2 * b.n) * b.llm_heads * b.tokens ** 2 * (dims.nope + dims.rope + dims.v)
    assert fc.get_total_flops() == pytest.approx(2 * counts_moe.forward_flops(cfg) + padding + attention, rel=1e-9)


def test_published_counts():
    """About 7.2 TFLOP a window, 14.5 TFLOP of routed products a layer and
    batch of 16 (838,368 rows), bound by operations."""
    cfg = spec.config("dsv2_lite")
    assert counts_moe.forward_flops(cfg) == pytest.approx(7.29e12, rel=0.01)
    flops, nbytes = counts_moe.experts_span(cfg, 16, 16)
    assert flops / 4 == pytest.approx(14.5e12, rel=0.01)
    least, by = counts.least_seconds(flops / 4, nbytes / 4, "NVIDIA H100 80GB HBM3")
    assert by == "operations" and least == pytest.approx(14.7e-3, rel=0.01)


def test_the_cell_is_correct_and_reads_its_layers(tiny):
    line = run(tiny, trace=True)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) <= {m["name"] for m in spec.per_layer_of(CELL)}
    load = line["metrics"]["moe.load_max_over_mean.dsv2_lite"]["value"]
    experts = merged(tiny)["model"]["deepseek_v2"]["n_routed_experts"]
    assert 1.0 <= load <= experts


def test_readers_on_a_record():
    cfg = spec.config("dsv2_lite")
    record = {"config": cfg, "device_kind": "NVIDIA H100 80GB HBM3", "batch": 16,
              "window": {"windows": 256, "elapsed_s": 256 / 40.0},
              "trace": {"spans": {"moe_experts": [0.02] * 64}, "windows": 256, "window_s": 7.0}}
    roof = spec.reader("moe.experts_roofline.dsv2_lite").read(record)
    assert roof == pytest.approx(100 * 14.67e-3 / 0.02, rel=0.01)
    mfu = spec.reader("forecast.mfu.dsv2_lite").read(record)
    assert mfu == pytest.approx(100 * 40 * counts_moe.forward_flops(cfg) / 989e12)


@pytest.fixture
def planted(monkeypatch):
    """Plants one fault in the program's DeepSeek-V2 backbone."""
    from tec_mollm_tpu_torch.models import deepseek_v2 as dsv2

    real_gate, real_swiglu = dsv2.MoEGate.forward, dsv2.SwiGLU.forward

    def top5(self, x2):  # the least of the 6 weights dropped: top-5
        w, idx = real_gate(self, x2)
        return w.scatter(1, w.argmin(dim=1, keepdim=True), 0.0), idx

    def no_shared(self, x):  # the shared experts skipped, the dense layer kept
        return torch.zeros_like(x) if self.gate_proj.out_features != self_dense[0] else real_swiglu(self, x)

    def plain_rope(x, cos, sin):  # the halves rotated, not the interleaved pairs
        d = x.shape[-1]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    self_dense = [spec.config("dsv2_lite")["model"]["deepseek_v2"]["intermediate_size"]]
    faults = {
        "top5": (dsv2.MoEGate, "forward", top5),
        "no_shared": (dsv2.SwiGLU, "forward", no_shared),
        "no_mscale": (dsv2, "softmax_scale", lambda ds: ds.q_head_dim ** -0.5),
        "plain_rope": (dsv2, "apply_rotary", plain_rope),
    }

    def plant(kind):
        monkeypatch.setattr(*faults[kind])

    return plant


@pytest.mark.parametrize("kind", ["top5", "no_shared", "no_mscale", "plain_rope"])
def test_a_planted_fault_reads_not_correct(tiny, planted, kind):
    planted(kind)
    line = run(tiny)
    assert line["correct"] is False, line["checks"]


def test_controls_print_a_reading(tiny, tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(tiny))
    forecast_moe.main(["--workload", CELL, "--seeds", "5", "--device", "cpu", "--override", str(path)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["kind"] == "control_fp8" and row["forecast_err"] > 0.05
