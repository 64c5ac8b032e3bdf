"""Persistent forecast service on one GPU: load once, answer requests warm.

* loads the processed splits, the graph and the target scaler once;
* weights come from a port ``.pt`` state_dict file (the trainer's
  ``best_params.pt`` is one), or from a state_dict passed in memory; the model
  runs in eval mode at bf16 when ``cfg.train.bf16``;
* the graph's stencil feeds the stencil GAT kernel, a graph without one the
  padded-gather GAT; the model's route (``TECMoLLM.gat_route``) is reported by
  ``stats()`` and ``health()``;
* every request is padded to ``max_batch`` windows (one shape on the card);
* concurrent requests are coalesced into one device batch (``_DynamicBatcher``);
* forecasts come back in TECU: inverse target scaling, ``nan_to_num`` and a clip
  to [0, 200];
* stdlib HTTP: GET /healthz, /stats, /metrics; POST /forecast with
  ``{"indices": [i, ...], "split": "test"}`` -> ``{"indices", "forecast"
  (W, L_out, N), "latency_ms"}``.

Conformal band offsets and serving an exported artifact are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping

import numpy as np
import torch

from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.data.dataset import SlidingWindowDataset
from tec_mollm_tpu_torch.data.scaler import StandardScaler
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.graph.builder import GraphData
from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs, opt_in_kernel_refusal

logger = logging.getLogger(__name__)


def pad_batch_to_size(batch: dict[str, np.ndarray], size: int) -> dict[str, np.ndarray]:
    """Pad the leading axis to ``size`` rows by repeating the last row."""
    b = next(iter(batch.values())).shape[0]
    if b > size:
        raise ValueError(f"batch of {b} rows cannot pad down to {size}")
    if b == size:
        return batch
    return {k: np.concatenate([v, np.repeat(v[-1:], size - b, axis=0)]) for k, v in batch.items()}


class _DynamicBatcher:
    """Coalesce concurrent requests into one device batch.

    A daemon thread drains a queue: the first request opens a batch, then up to
    ``window_ms`` is spent topping it up with same-split requests (to
    ``max_batch`` rows) before one padded forward; results are sliced back."""

    _STOP = object()

    def __init__(self, service: "ForecastService", window_ms: float):
        self.service = service
        self.window_s = window_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self.batches = 0
        self.batched_rows = 0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="forecast-batcher", daemon=True)
        self._thread.start()

    def submit(self, split: str, idx: np.ndarray) -> np.ndarray:
        if self._closed:
            raise RuntimeError("forecast service is shutting down")
        slot: dict[str, Any] = {"split": split, "idx": idx, "event": threading.Event()}
        self.q.put(slot)
        if not slot["event"].wait(timeout=600.0):
            raise RuntimeError("forecast request timed out in the batch queue")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self) -> None:
        self._closed = True
        self.q.put(self._STOP)
        self._thread.join(timeout=10)
        while True:  # requests that raced close() must not wait forever
            try:
                slot = self.q.get_nowait()
            except queue.Empty:
                break
            if slot is not self._STOP:
                slot["error"] = RuntimeError("forecast service shut down")
                slot["event"].set()

    def _loop(self) -> None:
        carry = None
        while True:
            first = carry if carry is not None else self.q.get()
            carry = None
            if first is self._STOP:
                return
            group = [first]
            rows = len(first["idx"])
            deadline = time.perf_counter() + self.window_s
            while rows < self.service.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if (
                    nxt is self._STOP
                    or nxt["split"] != first["split"]
                    or rows + len(nxt["idx"]) > self.service.max_batch
                ):
                    carry = nxt  # the next cycle opens with it
                    break
                group.append(nxt)
                rows += len(nxt["idx"])
            try:
                ds = self.service.datasets[first["split"]]
                all_idx = np.concatenate([g["idx"] for g in group])
                with self.service._lock:
                    preds = self.service._run_padded(ds.gather_batch(all_idx), len(all_idx))
                off = 0
                for g in group:
                    g["result"] = preds[off : off + len(g["idx"])]
                    off += len(g["idx"])
                with self.service._stats_lock:
                    self.batches += 1
                    self.batched_rows += rows
            except Exception as e:  # noqa: BLE001 — delivered to the waiters
                for g in group:
                    g["error"] = e
            finally:
                for g in group:
                    g["event"].set()


class ForecastService:
    """Weights and data loaded once; thread-safe batched forecasting."""

    def __init__(
        self,
        cfg: Config,
        data_dir: str,
        checkpoint: str | None = None,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        max_batch: int = 8,
        splits: tuple[str, ...] = ("test",),
        batch_window_ms: float = 5.0,
        fused_attn: bool = False,
        use_fused_mlp: bool = False,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if (checkpoint is None) == (state_dict is None):
            raise ValueError("pass exactly one of checkpoint (a .pt path) or state_dict")
        self.cfg = cfg = cfg.resolved()
        self.dtype = torch.bfloat16 if cfg.train.bf16 else torch.float32
        if self.device.type == "cuda":
            reason = opt_in_kernel_refusal(cfg.model, self.dtype, fused_attn, use_fused_mlp)
            if reason is not None:
                raise ValueError(reason)
        self.datasets = {
            s: SlidingWindowDataset.from_dir(data_dir, s, cfg.train.L_in, cfg.train.L_out, stride=1)
            for s in splits
        }
        graph = GraphData.load(os.path.join(data_dir, "graph.npz"))
        tscaler_path = os.path.join(data_dir, "target_scaler.npz")
        self.tscaler = StandardScaler.load(tscaler_path) if os.path.exists(tscaler_path) else None

        if checkpoint is not None:
            state_dict = torch.load(checkpoint, map_location="cpu", weights_only=True)
        self.ckpt_path = checkpoint or "<in-memory state_dict>"
        shifts, self.graph = graph_inputs(graph, self.device)
        model = TECMoLLM(cfg.model, shifts, dtype=self.dtype, fused_attn=fused_attn, use_fused_mlp=use_fused_mlp)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch

        # one lock around device work; a separate one for the counters so that
        # /stats never waits behind a forward
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._latencies_ms: list[float] = []
        self._forward_ms: list[float] = []  # padded batch: host->device, forward, device->host
        self._count = 0

        t0 = time.perf_counter()
        first_name, first = next(iter(self.datasets.items()))
        if len(first) == 0:
            raise ValueError(
                f"split '{first_name}' has no complete windows: it is shorter than "
                f"L_in+L_out = {cfg.train.L_in + cfg.train.L_out} steps"
            )
        self._run_padded(first.gather_batch(np.zeros(1, np.int64)), 1)
        self.warmup_s = time.perf_counter() - t0
        self._batcher = _DynamicBatcher(self, batch_window_ms) if batch_window_ms > 0 else None
        logger.info(
            "service warm on %s: %s max_batch=%d first run %.1fs; GAT route: %s",
            self.device, self.ckpt_path, self.max_batch, self.warmup_s, self.model.gat_route,
        )

    def _run_padded(self, batch: dict[str, np.ndarray], n: int) -> np.ndarray:
        """Pad to max_batch, run, return (n, L_out, N, Q) fp32 on the host."""
        t0 = time.perf_counter()
        batch = pad_batch_to_size(batch, self.max_batch)
        # cast x on the host: half the bytes to the card in bf16
        x = torch.from_numpy(batch["x"]).to(self.dtype)
        tf = torch.from_numpy(batch["time_features"])
        with torch.inference_mode():
            preds = self.model(
                x.to(self.device, non_blocking=True), tf.to(self.device, non_blocking=True), *self.graph
            )
        out = preds[:n].cpu().numpy()
        with self._stats_lock:
            self._forward_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._forward_ms) > 10_000:
                del self._forward_ms[:-5_000]
        return out

    def forecast(self, indices: list[int], split: str = "test") -> dict[str, Any]:
        ds = self.datasets.get(split)
        if ds is None:
            raise KeyError(f"split {split!r} not served (have {list(self.datasets)})")
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size == 0 or idx.size > self.max_batch:
            raise ValueError(f"request must carry 1..{self.max_batch} indices (got {idx.size})")
        if (idx < 0).any() or (idx >= len(ds)).any():
            raise ValueError(f"indices out of range [0, {len(ds)})")

        t0 = time.perf_counter()
        if self._batcher is not None:
            preds = self._batcher.submit(split, idx)
        else:
            with self._lock:
                preds = self._run_padded(ds.gather_batch(idx), len(idx))
        latency_ms = (time.perf_counter() - t0) * 1e3

        phys = preds.astype(np.float64)  # (W, L_out, N, Q)
        if self.tscaler is not None:
            phys = phys * self.tscaler.scale_[0] + self.tscaler.mean_[0]
        phys = np.clip(np.nan_to_num(phys), 0.0, 200.0)
        with self._stats_lock:
            self._latencies_ms.append(latency_ms)
            if len(self._latencies_ms) > 10_000:  # bound memory on long-lived servers
                del self._latencies_ms[:-5_000]
            self._count += 1
        out = {
            "indices": idx.tolist(),
            "forecast": phys[..., self.cfg.model.median_index].tolist(),
            "latency_ms": round(latency_ms, 3),
        }
        if self.cfg.model.quantiles:
            out["quantile_levels"] = list(self.cfg.model.quantiles)
            out["forecast_quantiles"] = phys.tolist()
        return out

    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            lat = np.asarray(self._latencies_ms)
            fwd = np.asarray(self._forward_ms)
            count = self._count
        out: dict[str, Any] = {"requests": count, "gat_route": self.model.gat_route}
        if lat.size:
            out.update(
                p50_ms=round(float(np.percentile(lat, 50)), 3),
                p95_ms=round(float(np.percentile(lat, 95)), 3),
                mean_ms=round(float(lat.mean()), 3),
            )
        if fwd.size:  # the warm-up forward included
            out["forward_p50_ms"] = round(float(np.percentile(fwd, 50)), 3)
        batcher = self._batcher
        if batcher is not None:
            with self._stats_lock:
                b, r = batcher.batches, batcher.batched_rows
            out["batches"] = b
            if b:
                out["mean_batch_rows"] = round(r / b, 2)
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition-format snapshot of /stats."""
        s = self.stats()
        lines = [
            "# HELP tec_mollm_requests_total Forecast requests served.",
            "# TYPE tec_mollm_requests_total counter",
            f"tec_mollm_requests_total {s['requests']}",
        ]
        for k, name in (("p50_ms", "p50"), ("p95_ms", "p95"), ("mean_ms", "mean")):
            if k in s:
                lines += [
                    f"# TYPE tec_mollm_request_latency_{name}_ms gauge",
                    f"tec_mollm_request_latency_{name}_ms {s[k]}",
                ]
        if "batches" in s:
            lines += [
                "# HELP tec_mollm_batches_total Coalesced device dispatches.",
                "# TYPE tec_mollm_batches_total counter",
                f"tec_mollm_batches_total {s['batches']}",
            ]
            if "mean_batch_rows" in s:
                lines += [
                    "# TYPE tec_mollm_mean_batch_rows gauge",
                    f"tec_mollm_mean_batch_rows {s['mean_batch_rows']}",
                ]
        return "\n".join(lines) + "\n"

    def health(self) -> dict[str, Any]:
        return {
            "status": "ok",
            "device": str(self.device),
            "checkpoint": self.ckpt_path,
            "num_nodes": self.cfg.model.num_nodes,
            "L_in": self.cfg.train.L_in,
            "L_out": self.cfg.train.L_out,
            "max_batch": self.max_batch,
            "gat_route": self.model.gat_route,
            "splits": {k: len(v) for k, v in self.datasets.items()},
            "warmup_s": round(self.warmup_s, 2),
        }

    def close(self) -> None:
        """Stop the batcher thread."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None


def _make_handler(service: ForecastService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict) -> None:
            self._send(code, json.dumps(payload).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, service.health())
            elif self.path == "/stats":
                self._json(200, service.stats())
            elif self.path == "/metrics":
                self._send(200, service.metrics_text().encode(), "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/forecast":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                self._json(200, service.forecast(req.get("indices", []), req.get("split", "test")))
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep the server alive
                logger.exception("forecast request failed")
                self._json(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

    return Handler


def make_server(service: ForecastService, host: str = "127.0.0.1", port: int = 8901) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve(service: ForecastService, host: str = "127.0.0.1", port: int = 8901) -> None:
    """Blocking server loop."""
    httpd = make_server(service, host, port)
    logger.info("serving forecasts on http://%s:%d", host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
