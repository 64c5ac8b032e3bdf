"""A short first check of the SARIMA kernels and the ablation arms on one card.

    python scripts/probe_sarima_arms.py

Builds the kernels, runs the three SARIMA kernels (``csrc/sarima.cu``) once
at flagship shapes (a simulated (2000, 2911) series, season 12, 64 windows
of 48 steps) against their plain versions and times them (``chip_smoke.
time_ms``), fits 400 Adam steps through them and 3 steps kernel against
plain, then takes one train step of the flagship model at B = 2 (bf16,
``fused_attn``, dropout 0) under the default, ``dots_saveable`` remat,
``lean_gn``, ``fuse_conv`` and ``im2col_conv``: loss, two timed steps, peak
memory and the largest per-tensor gradient difference from the default.
``chip_smoke.py`` phase 14 measures the same at B = 8; this is the quick
probe to run after a change to the kernels.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from tec_mollm_tpu_torch import bench  # noqa: E402
from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates  # noqa: E402
from tec_mollm_tpu_torch.models import graph_inputs, sarima  # noqa: E402
from tec_mollm_tpu_torch.ops import _build  # noqa: E402
from tec_mollm_tpu_torch.ops import sarima as sops  # noqa: E402
from tec_mollm_tpu_torch.training import make_sum_loss_fn  # noqa: E402

ARMS = (("default", {}, None), ("dots", {}, "dots_saveable"), ("lean_gn", {"lean_gn": True}, None),
        ("fuse", {"fuse_conv": True}, None), ("im2col", {"im2col_conv": True}, None))


def main() -> None:
    print(cs.gpu_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print("build", time.perf_counter() - t0, flush=True)
    ptxas = (lib.parent / "ptxas.log").read_text()
    print("\n".join(line for line in ptxas.splitlines() if "sarima" in line.lower() or "error" in line.lower()))
    dev = torch.device("cuda")
    n, s = 2911, 12
    series = cs.simulate_sarima(2000, n, s, (0.6, 0, 0, 0), 0)
    y = sarima.scaled_difference(series, s, dev)
    raw = torch.randn(4, n, generator=torch.Generator(device=dev).manual_seed(0), device=dev) * 0.5
    c = (0.99 * torch.tanh(raw)).contiguous()
    scale = 2.0 / ((y.shape[0] - s - 1) * n)
    e_k, p_k = sops.css_forward(y, c, s)
    e_p, p_p = sops.css_forward_reference(y, c, s)
    g_k, g_p = sops.css_backward(y, e_k, c, s, scale), sops.css_backward_reference(y, e_p, c, s, scale)
    starts = np.linspace(0, 1952, 64).astype(int)
    wins = torch.tensor(np.stack([series[a : a + 48] for a in starts]), dtype=torch.float32, device=dev)
    f_k, f_p = sops.forecast(wins, c, 12, s), sops.forecast_reference(wins, c, 12, s)
    torch.cuda.synchronize()
    for name, a, b in (("e", e_k, e_p), ("partial", p_k, p_p), ("grad", g_k, g_p), ("forecast", f_k, f_p)):
        d = float((a - b).abs().max())
        print(name, d, d / float(b.abs().max()), flush=True)
    print("fwd ms", cs.time_ms(lambda: sops.css_forward(y, c, s), 20))
    print("bwd ms", cs.time_ms(lambda: sops.css_backward(y, e_k, c, s, scale), 20))
    print("fc ms", cs.time_ms(lambda: sops.forecast(wins, c, 12, s), 20))
    print("plain fwd ms", cs.time_ms(lambda: sops.css_forward_reference(y, c, s), 1, runs=2))
    t0 = time.perf_counter()
    params = sarima.fit_sarima(series, season=s, steps=400, device=dev)
    print("fit s", time.perf_counter() - t0, "phi mean", float(params.phi.mean()), flush=True)
    r_k, r_p = sarima.adam_fit(y, s, 3), sarima.adam_fit(y, s, 3, loss_and_grad=sops.css_loss_and_grad_reference)
    print("adam3", float((r_k - r_p).abs().max()), flush=True)

    _, graph_pair = graph_inputs(build_graph(*grid_coordinates(41, 71)), dev)
    grads = {}
    for name, kw, policy in ARMS:
        cfg = bench.bench_config("default", batch_size=2, remat_policy=policy)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0))
        run = bench.setup(cfg, dev, fused_attn=True, seed=0, **kw)
        model = run.state.model
        model.train()
        wsum, count = make_sum_loss_fn(model, cfg)(run.batch, graph_pair)
        loss = wsum / count
        loss.backward()
        grads[name] = {k: v.grad.float().clone() for k, v in run.state.trainable().items()}
        torch.cuda.reset_peak_memory_stats()
        run.step()
        run.sync()
        t0 = time.perf_counter()
        run.step()
        run.step()
        run.sync()
        print(name, "loss", float(loss.detach()), "step ms", (time.perf_counter() - t0) / 2 * 1e3,
              "peak", torch.cuda.max_memory_allocated() / 1e9, flush=True)
        if name != "default":
            ref = grads["default"]
            print("  worst", max((float((grads[name][k] - g).abs().max() / (g.abs().max() + 1e-12)), k)
                                 for k, g in ref.items()))
        del run, model
    print("counts", _build.launch_counts())


if __name__ == "__main__":
    main()
