"""The test CLI's scoring loop on TEC-MoLLM with a DeepSeek-V2 backbone:
``EvalExecutor.stream_metrics`` over the test split, pass after pass.

As the ``forecast`` driver (whose window, pass, RMSE and sample helpers it
takes), with this configuration's own weights and reference
(``reference/deepseek_v2.py``): set-up makes the seeded weights on the device
in one draw over ``deepseek_v2.specs``, builds the ``EvalExecutor`` from them
on a seeded test split and runs one pass as the warm-up. The traced pass opens
the benchmark's span around each DeepSeekMoE layer's routed experts
(``mlp.experts``).

The check: the reference's float32 predictions of the sampled batches
(``forecast_err``) and its RMSE by horizon over the whole split (``rmse_gap``)
against the window's. A token whose top-k differs between the program and the
reference near a tie is rounding, and counts in the sound runs' readings. At
the published depth those two numbers hold five layers of bf16 rounding and of
such flips, which hide a fault of one layer's mathematics; so ``attn_err`` and
``ffn_err`` hold each block's two sublayers apart: the program's input to each
sublayer and its output, tapped for ``TAP_ROWS`` sequences of the first
sampled batch, against the reference's sublayer on that same input (its own
float32 routing on the program's hidden state): the largest relative gap of
any attention or FFN sublayer at any token position (``layer_gaps``).

    python3 -m benchmark.drivers.forecast_moe --workload <cell> --seeds 11 12 13

prints the float8 control's readings (every product's operands in float8
e4m3 in the reference, in the program's place), one JSON line a seed.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import tempfile

import numpy as np
import torch

from benchmark import harness
from benchmark import trace as trace_lib
from benchmark import traffic as traffic_lib
from benchmark.drivers import common
from benchmark.drivers import forecast
from benchmark.reference import deepseek_v2 as rd
from benchmark.reference import model as ref
from benchmark.weights import WEIGHT_STREAM

SPAN = "moe_experts"
# the sequences (node rows of a batch) whose sublayers ``layer_gaps`` compares
TAP_ROWS = 1024
window, close, program_and_starts, rmse_tecu, rmse_gap = (
    forecast.window, forecast.close, forecast.program_and_starts, forecast.rmse_tecu, forecast.rmse_gap)


def seeded_weights(ctx) -> dict[str, torch.Tensor]:
    """``weights.make``'s draw over this configuration's specs."""
    specs = rd.specs(rd.Dims.of(ctx.config))
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=ctx.device).manual_seed((ctx.seed ^ WEIGHT_STREAM) % 2**63)
    flat = torch.randn(total, generator=g, device=ctx.device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, mean, std in specs:
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape).mul_(std).add_(mean)
        off += size
    return out


def sample_batches(ctx, windows: int, batch: int) -> list[int]:
    batches = -(-windows // batch)
    g = traffic_lib.rng(ctx.seed, 0xC4EC)
    return sorted(g.choice(batches, size=min(int(ctx.traffic["check_batches"]), batches), replace=False).tolist())


def setup(ctx):
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
    from tec_mollm_tpu_torch.data.scaler import StandardScaler
    from tec_mollm_tpu_torch.evaluation.harness import EvalExecutor

    if ctx.world > 1:
        raise ValueError("the forecast_moe driver runs on one chip")
    cfg = common.program_config(ctx)
    windows = int(ctx.traffic["test_windows"])
    data = traffic_lib.split(ctx.config, windows, ctx.seed, stream=1)
    ds = SlidingWindowDataset(data, cfg.train.L_in, cfg.train.L_out, stride=1)
    scaler = StandardScaler(mean=np.array([traffic_lib.TARGET_MEAN]), scale=np.array([traffic_lib.TARGET_SCALE]))
    batch = int(ctx.traffic.get("batch_size") or cfg.train.eval_batch_size)
    ex = EvalExecutor(cfg, common.program_graph(ctx), seeded_weights(ctx), batch, ctx.device)
    common.free(ctx.device)
    sample = sample_batches(ctx, len(ds), batch)
    s = {"ctx": ctx, "ex": ex, "ds": ds, "scaler": scaler, "data": data, "batch": batch, "sample": sample,
         "seen": 0, "keep": False, "kept": {}}

    def hook(module, args, output):
        if s["keep"] and s["seen"] in sample:
            s["kept"][s["seen"]] = output[..., 0].detach().float().clone()
        s["seen"] += 1

    s["hook"] = ex.model.register_forward_hook(hook)
    s["taps"], s["tap_hooks"] = {}, tap_sublayers(ex.model, s)
    ex.stream_metrics(ds, scaler)  # the warm-up pass
    return s


def tap_rows(ctx, sequences: int, device) -> torch.Tensor:
    g = traffic_lib.rng(ctx.seed, 0x7A95)
    return torch.as_tensor(np.sort(g.choice(sequences, size=min(TAP_ROWS, sequences), replace=False)), device=device)


def tap_sublayers(model, s) -> list:
    """Forward hooks that keep, in the window's first pass, the input and the
    output of every block's ``self_attn`` and ``mlp`` for the tapped rows of
    the first sampled batch, on the device (read after the window)."""

    def tap(key, module, args, output):
        if s["keep"] and s["seen"] == s["sample"][0]:
            if "tap_rows" not in s:
                s["tap_rows"] = tap_rows(s["ctx"], args[0].shape[0], args[0].device)
            rows = s["tap_rows"]
            s["taps"][key] = (args[0][rows].detach().clone(), output[rows].detach().clone())

    handles = []
    for i, layer in enumerate(model.llm_backbone.model.layers):
        for kind in ("self_attn", "mlp"):
            handles.append(getattr(layer, kind).register_forward_hook(functools.partial(tap, (i, kind))))
    return handles


def traced(s) -> dict:
    """One whole pass under the profiler, each layer's routed experts inside
    a span."""
    model = s["ex"].model
    spans = [trace_lib.Span(m, SPAN) for name, m in model.named_modules() if name.endswith(".mlp.experts")]
    t = trace_lib.Capture(s["ctx"].device)
    try:
        with t:
            forecast._pass(s)
    finally:
        for span in spans:
            span.remove()
    summary = trace_lib.reduce(t)
    summary["windows"] = len(s["ds"])
    return {"trace": summary, "batch": s["batch"]}


def reference_forecasts(ctx, data: dict, starts: np.ndarray, prec: ref.Precision, block: int = 16) -> np.ndarray:
    """(W, L_out, N) scaled predictions of the windows at ``starts``, in blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, dims, graph = seeded_weights(ctx), rd.Dims.of(ctx.config), ref.Graph(ctx.config, ctx.device)
    out = []
    with torch.no_grad():
        for i in range(0, len(starts), block):
            x, tf, _ = traffic_lib.windows_of(data, starts[i:i + block], dims.base.l_in)
            x = torch.as_tensor(x, device=ctx.device)
            tf = torch.as_tensor(tf, device=ctx.device)
            out.append(rd.forward(params, x, tf, graph, dims, prec)[..., 0].cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def sublayer(params: dict, dims: rd.Dims, layer: int, kind: str, x: torch.Tensor, prec: ref.Precision):
    """The reference's sublayer ``kind`` of block ``layer`` on ``x`` (M, T, d)."""
    p = f"{rd.BACKBONE}.layers.{layer}"
    if kind == "self_attn":
        return rd.attention(params, f"{p}.self_attn", x, dims, prec)
    if dims.moe(layer):
        return rd.moe(params, f"{p}.mlp", x, dims, prec, None)
    return rd.swiglu(params, f"{p}.mlp", x, prec)


def layer_gaps(params: dict, dims: rd.Dims, taps: dict, prec: ref.Precision, device) -> dict[str, float]:
    """``attn_err`` and ``ffn_err``: the largest ||output - reference|| /
    ||reference|| over the tapped attention (MLA) and FFN (dense or MoE)
    sublayers, the reference run on each tapped input, taken token position
    by position: position 0 attends to itself alone, so a fault of the
    attention shows at the later positions only."""
    worst = {"attn_err": 0.0, "ffn_err": 0.0}
    with torch.no_grad():
        for (layer, kind), (x, out) in sorted(taps.items()):
            want = sublayer(params, dims, layer, kind, x.to(device, torch.float32), prec)
            diff = torch.linalg.vector_norm(out.to(device, torch.float32) - want, dim=(0, 2))
            gap = float((diff / torch.linalg.vector_norm(want, dim=(0, 2))).max())
            key = "attn_err" if kind == "self_attn" else "ffn_err"
            worst[key] = max(worst[key], gap)
    return worst


def check(s) -> list[tuple[str, float, float]]:
    ctx = s["ctx"]
    s["hook"].remove()
    for h in s["tap_hooks"]:
        h.remove()
    del s["ex"]
    common.free(ctx.device)
    got, starts = program_and_starts(s)
    preds = reference_forecasts(ctx, s["data"], np.arange(len(s["ds"])), ref.Precision())
    layers = layer_gaps(seeded_weights(ctx), rd.Dims.of(ctx.config), s["taps"], ref.Precision(), ctx.device)
    limits = ctx.limits
    return [
        ("forecast_err", common.relative_error(got, preds[starts]), limits.get("forecast_err", 0.0)),
        ("rmse_gap", rmse_gap(s["metrics"]["rmse_by_horizon"], rmse_tecu(ctx, s["data"], preds)),
         limits.get("rmse_gap", 0.0)),
    ] + [(k, v, limits.get(k, 0.0)) for k, v in layers.items()]


def reference_taps(ctx, data: dict, starts: np.ndarray) -> dict:
    """The float32 reference's input and output of every sublayer for the
    tapped rows of the windows at ``starts``, as ``tap_sublayers`` keeps the
    program's."""
    params, dims, graph = seeded_weights(ctx), rd.Dims.of(ctx.config), ref.Graph(ctx.config, ctx.device)
    prec = ref.Precision()
    x, tf, _ = traffic_lib.windows_of(data, starts, dims.base.l_in)
    taps = {}
    with torch.no_grad():
        h = rd.front_end(params, torch.as_tensor(x, device=ctx.device), torch.as_tensor(tf, device=ctx.device),
                         graph, dims.base, prec)
        rows = tap_rows(ctx, h.shape[0], ctx.device)
        for i in range(dims.base.layers):
            p = f"{rd.BACKBONE}.layers.{i}"
            for kind, norm in (("self_attn", "input_layernorm"), ("mlp", "post_attention_layernorm")):
                a = rd.rms_norm(h, params[f"{p}.{norm}.weight"], dims.eps)
                out = sublayer(params, dims, i, kind, a, prec)
                taps[(i, kind)] = (a[rows], out[rows])
                h = h + out
    return taps


def control(ctx) -> dict:
    """The float8 control's readings on the cell's inputs and weights."""
    n = int(ctx.traffic["test_windows"])
    data = traffic_lib.split(ctx.config, n, ctx.seed, stream=1)
    batch = int(ctx.traffic["batch_size"])
    starts = np.concatenate([np.arange(k * batch, min((k + 1) * batch, n)) for k in sample_batches(ctx, n, batch)])
    every = np.arange(n)
    want = reference_forecasts(ctx, data, every, ref.Precision())
    got = reference_forecasts(ctx, data, every, ref.Precision(fp8=True))
    first = sample_batches(ctx, n, batch)[0]
    taps = reference_taps(ctx, data, np.arange(first * batch, min((first + 1) * batch, n)))
    layers = layer_gaps(seeded_weights(ctx), rd.Dims.of(ctx.config), taps, ref.Precision(fp8=True), ctx.device)
    return {"kind": "control_fp8", "forecast_err": common.relative_error(got[starts], want[starts]),
            "rmse_gap": rmse_gap(rmse_tecu(ctx, data, got), rmse_tecu(ctx, data, want)), **layers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.drivers.forecast_moe")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default=None)
    args = p.parse_args(argv)
    overrides = json.load(open(args.override)) if args.override else {}
    cell, config, traffic = harness.load(args.workload, overrides)
    device = torch.device(args.device)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp:
            row = control(harness.Ctx(args.workload, cell, config, traffic, seed, device, tmp))
        print(json.dumps({"cell": args.workload, "seed": seed, **row}), flush=True)
        common.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
