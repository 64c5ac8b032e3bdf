#!/usr/bin/env python3
"""Drive the PyTorch port (tec_mollm_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile the kernels from csrc/ (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at the
     shapes the flagship eval batch gives it, with its error, its time (median of
     CUDA-event timed launches), the plain version's time, a library call's time
     where one computes the same function, and its bound on this card;
  4. serve: a synthetic processed dir at the 41x71 grid, ForecastService on the
     flagship Config() with seeded random weights at max_batch=8 in bf16,
     forecast requests over HTTP on localhost (some concurrent, so the batcher
     coalesces), first on the default path and then with fused_attn and
     use_fused_mlp; launch counts are zeroed before and read after each run;
     forecasts are checked for shape and finiteness, against an fp32 forward of
     the plain path, and the two paths against each other.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel JSON. Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}

# kernel vs plain version on the card: |kernel - plain| <= ATOL + RTOL * |plain|.
# Both compute in fp32 and round the output to the tensor's dtype; they differ
# in the order of fp32 sums (and, in the fused MLP, in the bf16 rounding of the
# hidden activations), so a bf16 output may differ by one bf16 ulp (2^-8 relative).
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-5, 1e-5)}
# served forecasts, in scaled units: bf16 through 3 GPT-2 blocks against an fp32
# forward, and the fused kernels against the default path (two-pass vs lean LN,
# fp32 vs bf16 q*k products)
SERVE_TOL_SCALED = 0.1
# the flagship eval batch (the service's max_batch, and the kernels' batch),
# CUDA-event timed launches per kernel, timesteps of the synthetic test split,
# forecast requests and the threads that send the concurrent ones
BATCH, REPS, STEPS, REQUESTS, THREADS = 8, 20, 150, 16, 6
# target scaler of the synthetic processed dir: TECU = scaled * SCALE + MEAN
TARGET_MEAN, TARGET_SCALE = 25.0, 12.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timed calls after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, dtype_name: str) -> tuple[float, float, bool]:
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool(((diff <= atol + rtol * w.abs()) & g.isfinite()).all())
    return max_abs, max_rel, ok


def bound(bytes_moved: float, flops: float, flop_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(args, graph, results: dict) -> list[dict]:
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config

    cfg = Config().resolved().model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_real = cfg.num_nodes
    n = -(-n_real // 128) * 128  # the model pads the node axis to 2944
    rows = BATCH * n
    rows_llm = rows * cfg.num_patches
    d, heads = cfg.d_llm, cfg.llm_heads
    entries, failures = [], []

    def rand(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    # --- 1. stencil GAT at (B*L, H*C, N) ---
    shifts = tuple(int(s) for s in graph.stencil_shifts)
    valid = torch.zeros(len(shifts), n, dtype=torch.bool, device=dev)
    valid[:, :n_real] = torch.as_tensor(graph.stencil_valid, device=dev)
    m, hc = BATCH * cfg.temporal_seq_len, cfg.spatial_channels
    att = rand(cfg.spatial_heads, cfg.spatial_out_channels, dtype=torch.float32, std=0.3)
    per_dtype = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xl, xr = rand(m, hc, n, dtype=dt), rand(m, hc, n, dtype=dt)
        got = ops.gat_stencil_attention(xl, xr, valid, att, shifts)
        want = ops.gat_stencil_reference(xl, xr, valid, att, shifts)
        torch.cuda.synchronize()
        per_dtype[name] = compare(got, want, name) + (xl, xr)
    xl, xr = per_dtype["bf16"][3:]
    valid_pairs = int(valid.sum())
    gat = {
        "name": "gat_stencil", "source": "tec_mollm_tpu_torch/csrc/gat_stencil.cu",
        "replaces": "tec_mollm_tpu/ops/gat_stencil.py:104",
        "shape": f"xl,xr ({m},{hc},{n}) bf16; valid ({len(shifts)},{n})",
        "ms": time_ms(lambda: ops.gat_stencil_attention(xl, xr, valid, att, shifts), REPS),
        "plain_ms": time_ms(lambda: ops.gat_stencil_reference(xl, xr, valid, att, shifts), REPS),
        "library_ms": None,
        "bytes": 3 * m * hc * n * 2 + valid.numel() + att.numel() * 4,
        # per valid (node, offset) pair and slice: add, leaky-relu, multiply-add
        # per channel for the score, exp, and a multiply-add per channel for the sum
        "flops": m * valid_pairs * (hc * 5 + 2 * hc + 4),
        "flop_rate": PEAK_FLOPS["fp32"],
    }
    for name in ("fp32", "bf16"):
        gat[f"max_abs_err_{name}"], gat[f"max_rel_err_{name}"], ok = per_dtype[name][:3]
        gat[f"tol_{name}"] = TOL[name]
        if not ok:
            failures.append(f"gat_stencil {name}")
    gat["max_abs_err"] = gat["max_abs_err_bf16"]
    entries.append(gat)

    # --- 2. short causal attention at (B*N, T, D), q/k/v views of the c_attn output ---
    t = cfg.num_patches
    qkv = rand(rows, t, 3 * d)
    q, k, v = qkv.split(d, dim=-1)
    got = ops.short_causal_attention(q, k, v, heads)
    want = ops.short_causal_attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = compare(got, want, "bf16")
    if not ok:
        failures.append("short_attention bf16")
    hd = d // heads
    q4, k4, v4 = (a.reshape(rows, t, heads, hd).transpose(1, 2) for a in (q, k, v))
    entries.append({
        "name": "short_attention", "source": "tec_mollm_tpu_torch/csrc/short_attention.cu",
        "replaces": "tec_mollm_tpu/ops/short_attention.py:253",
        "shape": f"q,k,v ({rows},{t},{d}) bf16, {heads} heads",
        "max_abs_err": max_abs, "max_rel_err_bf16": max_rel, "tol_bf16": TOL["bf16"],
        "ms": time_ms(lambda: ops.short_causal_attention(q, k, v, heads), REPS),
        "plain_ms": time_ms(lambda: ops.short_causal_attention_reference(q, k, v, heads), REPS),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True), REPS
        ),
        "bytes": 4 * rows * t * d * 2,
        "flops": rows * heads * (t * (t + 1) // 2) * hd * 4,
        "flop_rate": PEAK_FLOPS["fp32"],
    })

    # --- 3. fused LN -> MLP -> residual at (B*N*T, d) ---
    dh = cfg.llm_mlp_ratio * d
    x = rand(rows_llm, d)
    ln_w = 1.0 + rand(d, dtype=torch.float32, std=0.1)
    ln_b = rand(d, dtype=torch.float32, std=0.1)
    w1, b1 = rand(d, dh, dtype=torch.float32, std=0.02), rand(dh, dtype=torch.float32, std=0.02)
    w2, b2 = rand(dh, d, dtype=torch.float32, std=0.02), rand(d, dtype=torch.float32, std=0.02)
    mlp_args = (x, ln_w, ln_b, w1, b1, w2, b2)
    got = ops.fused_ln_mlp(*mlp_args)
    want = ops.fused_ln_mlp_reference(*mlp_args)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = compare(got, want, "bf16")
    if not ok:
        failures.append("fused_mlp bf16")
    # The residual (|x| ~ 1) dominates the output, so the check above barely sees
    # an error in the MLP branch (~0.35). Scaled by 2^-6 (exact in bf16), x keeps
    # its LN output and the same branch, and the output is about the branch alone:
    # the same tolerance then bounds the GEMMs and their epilogues.
    x_small = x * 2.0**-6
    got_s = ops.fused_ln_mlp(x_small, *mlp_args[1:])
    want_s = ops.fused_ln_mlp_reference(x_small, *mlp_args[1:])
    torch.cuda.synchronize()
    branch_abs, branch_rel, ok = compare(got_s, want_s, "bf16")
    if not ok:
        failures.append("fused_mlp bf16, branch alone")
    entries.append({
        "name": "fused_mlp", "source": "tec_mollm_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "tec_mollm_tpu/ops/fused_mlp.py:78",
        "shape": f"x ({rows_llm},{d}) bf16, w1 ({d},{dh}), w2 ({dh},{d})",
        "max_abs_err": max_abs, "max_rel_err_bf16": max_rel, "tol_bf16": TOL["bf16"],
        "max_abs_err_branch": branch_abs, "max_rel_err_branch": branch_rel, "tol_branch": TOL["bf16"],
        "ms": time_ms(lambda: ops.fused_ln_mlp(*mlp_args), REPS),
        "plain_ms": time_ms(lambda: ops.fused_ln_mlp_reference(*mlp_args), REPS),
        "library_ms": None,
        "bytes": 2 * rows_llm * d * 2 + 2 * d * dh * 2 + (3 * d + dh) * 4,
        "flops": 4 * rows_llm * d * dh,
        "flop_rate": PEAK_FLOPS["bf16_tensor"],
    })

    for e in entries:
        e["bound_ms"], e["bound_by"] = bound(e["bytes"], e["flops"], e.pop("flop_rate"))
        e["route"] = "cuda"
        lib_ms = "-" if e["library_ms"] is None else "%.4f ms" % e["library_ms"]
        errs = ", ".join(
            "%s max_abs %.3e max_rel %.3e (tol atol %g rtol %g)" % (
                name, e[f"max_abs_err_{name}" if f"max_abs_err_{name}" in e else "max_abs_err"],
                e[f"max_rel_err_{name}"], *e[f"tol_{name}"])
            for name in ("fp32", "bf16", "branch") if f"max_rel_err_{name}" in e
        )
        log(
            f"kernel {e['name']}: {e['shape']}: {errs}; kernel {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, library {lib_ms}, bound {e['bound_ms']:.4f} ms ({e['bound_by']})"
        )
    results["kernel_failures"] = failures
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return entries


def ptxas_summary(log_text: str) -> list[str]:
    """One line per source from nvcc's -Xptxas -v log: kernels, registers, spills."""
    out, name, regs, spills = [], None, [], 0

    def flush():
        if name is not None:
            span = f"{min(regs)}-{max(regs)}" if regs else "?"
            out.append(f"{name}: {len(regs)} kernels, {span} registers, {spills} bytes spilled")

    for line in log_text.splitlines():
        line = line.strip()
        if line.startswith("== "):
            flush()
            name, regs, spills = line[3:], [], 0
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
        elif "spill stores" in line:
            spills += int(line.split("bytes spill stores")[0].split(",")[-1])
    flush()
    return out


def profile_forward(service, batch: dict, n: int, top: int = 12) -> dict:
    """torch.profiler over one padded forward: device time by kernel, the
    device's busy share of the forward's wall time (kernels and copies run on
    one stream, so their times add without overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service._run_padded(batch, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # a host op's device time repeats its kernels' times
        rows.append((float(e.self_device_time_total) / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        raise RuntimeError("the profiler recorded no device time for a forward on the card")
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "top": [{"ms": ms, "calls": c, "name": k[:120]} for ms, c, k in rows[:top]],
    }


def write_processed_dir(path: str, graph, cfg, seed: int, steps: int) -> None:
    from tec_mollm_tpu_torch.data.scaler import StandardScaler

    rng = np.random.default_rng(seed)
    n = cfg.model.num_nodes
    t = np.arange(steps)
    # scaled TEC-like series: a diurnal cycle (12 steps a day) plus noise
    diurnal = np.sin(2 * np.pi * t / 12.0)[:, None]
    tec = (diurnal + 0.3 * rng.standard_normal((steps, n))).astype(np.float32)
    x = np.concatenate(
        [tec[..., None], 0.5 * rng.standard_normal((steps, n, cfg.model.in_features - 1))], axis=-1
    ).astype(np.float32)
    horizon = cfg.train.L_out
    y = np.stack([np.roll(tec, -h - 1, axis=0) for h in range(horizon)], axis=-1).astype(np.float32)
    tf = np.stack([t % 12, (t // 12) % 366, np.full_like(t, 11), ((t // 12) // 91) % 4], axis=-1)
    np.savez(os.path.join(path, "test_set.npz"), X=x, Y=y, time_features=tf.astype(np.int32))
    graph.save(os.path.join(path, "graph.npz"))
    StandardScaler(mean=np.array([TARGET_MEAN]), scale=np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))


def drive_http(service, requests: list[list[int]], threads: int) -> tuple[dict, float]:
    """POST every request to a localhost server around `service`; returns
    ({tuple(indices): forecast}, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from tec_mollm_tpu_torch.serving import make_server

    httpd = make_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def post(idx: list[int]):
        body = json.dumps({"indices": idx, "split": "test"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/forecast", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return tuple(idx), np.asarray(out["forecast"], dtype=np.float64)

    try:
        t0 = time.perf_counter()
        serial, concurrent = requests[:4], requests[4:]
        results = [post(i) for i in serial]
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results += list(pool.map(post, concurrent))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    return dict(results), wall


def serve_phase(args, graph, data_dir: str, results: dict) -> dict:
    import torch

    from tec_mollm_tpu_torch import ops
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
    from tec_mollm_tpu_torch.serving import ForecastService

    cfg = Config().resolved()  # bf16 compute, the flagship widths
    write_processed_dir(data_dir, graph, cfg, args.seed, STEPS)
    shifts, _ = graph_inputs(graph, "cpu")
    state = TECMoLLM(cfg.model, shifts, seed=args.seed).state_dict()

    rng = np.random.default_rng(args.seed)
    n_windows = STEPS - cfg.train.L_in - cfg.train.L_out + 1
    requests = [rng.integers(0, n_windows, size=int(rng.integers(1, 4))).tolist() for _ in range(REQUESTS)]
    n_req_windows = sum(len(r) for r in requests)
    paths = {}
    for path, flags in (("default", {}), ("fused", {"fused_attn": True, "use_fused_mlp": True})):
        service = ForecastService(cfg, data_dir, state_dict=state, max_batch=BATCH, **flags)
        try:
            ops.reset_counts()
            forecasts, wall = drive_http(service, requests, THREADS)
            counts = ops.launch_counts()
            stats = service.stats()
            # one full batch of 8 windows through the model, timed on the host
            full = service.datasets["test"].gather_batch(np.arange(BATCH))
            fwd = []
            for _ in range(5):
                t0 = time.perf_counter()
                service._run_padded(full, BATCH)
                fwd.append(time.perf_counter() - t0)
            prof = profile_forward(service, full, BATCH)
        finally:
            service.close()
        for idx, f in forecasts.items():
            if f.shape != (len(idx), cfg.train.L_out, cfg.model.num_nodes) or not np.isfinite(f).all():
                raise RuntimeError(f"{path}: forecast for {idx} has shape {f.shape} or is not finite")
        fwd_s = statistics.median(fwd)
        paths[path] = {
            "forecasts": forecasts, "launches": counts, "stats": stats,
            "requests": len(requests), "windows": n_req_windows, "wall_s": wall,
            "windows_per_s_served": n_req_windows / wall,
            "batch_forward_ms": fwd_s * 1e3,
            "windows_per_s_full_batch": BATCH / fwd_s,
            "forwards": stats.get("batches"),
            "profile": prof,
        }
        log(
            f"serve[{path}]: {len(requests)} requests ({n_req_windows} windows) in {wall:.3f} s "
            f"-> {n_req_windows / wall:.2f} windows/s; p50 {stats.get('p50_ms')} ms, "
            f"p95 {stats.get('p95_ms')} ms; {stats.get('batches')} device batches "
            f"(mean {stats.get('mean_batch_rows')} rows, padded forward p50 "
            f"{stats.get('forward_p50_ms')} ms); full batch of {BATCH}: "
            f"{fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} windows/s; launches {counts}"
        )
        log(
            f"profile[{path}]: one batch of {BATCH}: wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']:.2f} ms (busy {prof['device_busy_share']:.2%})"
        )
        for row in prof["top"][:8]:
            log(f"  {row['ms']:8.3f} ms x{row['calls']:<4d} {row['name']}")

    need = {"default": ["gat_stencil"], "fused": ["gat_stencil", "short_attention", "fused_mlp"]}
    for path, names in need.items():
        missing = [k for k in names if paths[path]["launches"].get(k, 0) == 0]
        if missing:
            raise RuntimeError(f"serve[{path}] never launched {missing}")

    # the two paths against each other, and against an fp32 forward of the plain path
    a, b = paths["default"]["forecasts"], paths["fused"]["forecasts"]
    diff_paths = max(float(np.abs(a[k] - b[k]).max()) for k in a) / TARGET_SCALE
    first = requests[0]
    ref_model = TECMoLLM(cfg.model, shifts, dtype=torch.float32, gat_kernel=False)
    ref_model.load_state_dict(state)
    ref_model = ref_model.to("cuda").eval()
    from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset

    ds = SlidingWindowDataset.from_dir(data_dir, "test", cfg.train.L_in, cfg.train.L_out)
    batch = ds.gather_batch(np.asarray(first))
    _, valid = graph_inputs(graph, "cuda")
    with torch.inference_mode():
        ref = ref_model(
            torch.from_numpy(batch["x"]).cuda(), torch.from_numpy(batch["time_features"]).cuda(), valid
        )[..., 0].cpu().numpy().astype(np.float64)
    ref = np.clip(ref * TARGET_SCALE + TARGET_MEAN, 0.0, 200.0)
    diff_ref = float(np.abs(a[tuple(first)] - ref).max()) / TARGET_SCALE
    results["serve_check"] = {
        "max_abs_diff_fused_vs_default_scaled": diff_paths,
        "max_abs_diff_default_vs_fp32_plain_scaled": diff_ref,
        "tol_scaled": SERVE_TOL_SCALED,
    }
    log(
        f"serve check: fused vs default max |diff| {diff_paths:.4e}, default (bf16, kernels) vs "
        f"fp32 plain path {diff_ref:.4e} (scaled units; tol {SERVE_TOL_SCALED})"
    )
    if not (diff_paths <= SERVE_TOL_SCALED and diff_ref <= SERVE_TOL_SCALED):
        raise RuntimeError("served forecasts disagree beyond the stated tolerance")
    for p in paths.values():
        del p["forecasts"]
    return paths


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
        from tec_mollm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the tec_mollm_tpu_torch package is not importable: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results: dict = {}
    card = gpu_line()
    log(f"device: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    results["device"] = {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {lib} in {build_s:.1f} s")
    ptxas = (lib.parent / "ptxas.log").read_text() if (lib.parent / "ptxas.log").exists() else ""
    for line in ptxas_summary(ptxas):
        log(f"  {line}")
    results["build_s"] = build_s
    results["ptxas"] = ptxas

    lat, lon = grid_coordinates(41, 71)
    graph = build_graph(lat, lon, distance_threshold_km=150.0)
    entries = check_kernels(args, graph, results)
    results["kernels"] = entries
    with tempfile.TemporaryDirectory(prefix="tec_smoke_") as data_dir:
        paths = serve_phase(args, graph, data_dir, results)
    results["serve"] = paths
    for e in entries:
        # launches over both serve runs, each counted from zero
        e["launches"] = sum(p["launches"].get(e["name"], 0) for p in paths.values())
        e["launches_per_forward_fused"] = paths["fused"]["launches"].get(e["name"], 0) / paths["fused"]["forwards"]
    results["card"] = card
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{k: e.get(k) for k in keys} for e in entries]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
