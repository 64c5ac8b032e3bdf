"""One run of one cell, in this process: set up, warm up, measure, trace,
check, and the result line.

``run_cell`` is the in-process entry: ``run.py`` calls it after its look for
the chips, and the tests call it on the CPU at a tiny size (``overrides``).
A driver (``drivers/<kind>.py``) has four functions: ``setup(ctx)`` builds the
program's objects, warms up every shape the cell uses and drives any first
steps the check follows; ``window(session, seconds)`` measures; ``traced
(session)`` runs a bounded segment of the same work under the profiler and
returns what the per-layer metrics read besides the trace; ``check(session)``
frees the program's state, runs the reference and returns the compared
numbers. ``close(session)`` stops what ``setup`` started.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time
from typing import Any

import torch

from benchmark import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "tec_mollm_tpu")


@dataclasses.dataclass
class Ctx:
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    tmp: str
    rank: int = 0
    world: int = 1
    store: str | None = None

    @property
    def limits(self) -> dict:
        return self.cell.get("limits", {})


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load(name: str, overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a cell; ``overrides`` merges into the
    configuration and the traffic ({"config": {...}, "traffic": {...}}): the
    tests' tiny sizes."""
    overrides = overrides or {}
    cell = spec.cell(name)
    config = merge(spec.config(cell["config"]), overrides.get("config", {}))
    traffic = merge(spec.traffic(cell["traffic"]), overrides.get("traffic", {}))
    return cell, config, traffic


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    rank: int = 0,
    world: int = 1,
    store: str | None = None,
    overrides: dict | None = None,
    t0: float | None = None,
    log=print,
) -> dict | None:
    """The result line's object (rank 0; None on the other ranks);
    ``overrides`` as in ``load``."""
    t0 = time.perf_counter() if t0 is None else t0
    cell, config, traffic = load(name, overrides)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    driver = spec.driver(traffic["driver"])
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = Ctx(name, cell, config, traffic, seed, dev, tmp, rank, world, store)
        session = driver.setup(ctx)
        try:
            setup_s = time.perf_counter() - t0
            win = driver.window(session, seconds)
            leaked = forbidden_modules()
            if leaked:
                raise RuntimeError(f"modules of JAX or the JAX package were loaded: {leaked}")
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
            record: dict[str, Any] = {"window": win, "config": config, "traffic": traffic, "cell": cell,
                                      "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
            if trace:
                extra = driver.traced(session)
                record.update(extra)
            checks = driver.check(session)
        finally:
            driver.close(session)
    if rank != 0:
        return None
    correct = bool(checks) and all(value <= limit for _, value, limit in checks)
    log("notes " + json.dumps(win.get("notes", {})), file=sys.stderr)
    for check_name, value, limit in checks:
        log(f"check {check_name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    metrics: dict[str, dict] = {}
    breakdown = None
    if trace:
        for entry in spec.per_layer_of(name):
            value = spec.reader(entry["name"]).read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        t = record["trace"]
        breakdown = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    else:
        measured = dict(win["metrics"], setup_s=setup_s)
        for entry in spec.end_to_end_of(name):
            value = spec.lookup(measured, entry["name"])
            if value is None:
                raise RuntimeError(f"the {traffic['driver']} driver measures nothing for {entry['name']!r}")
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info: dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": record["device_kind"],
        "count": world,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = record["trace"]["window_s"]
    line: dict[str, Any] = {
        "correct": correct,
        "attempted": int(win["attempted"]),
        "failed": int(win["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c: {"value": v, "limit": lim} for c, v, lim in checks}
    return line


def dumps(line: dict) -> str:
    return json.dumps(line, allow_nan=False)
