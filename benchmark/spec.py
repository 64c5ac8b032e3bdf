"""The benchmark's files, found by name.

A cell is ``workloads/<cell>.json``: its configuration, traffic mix, chips,
``why`` and the limits of the numbers that decide ``correct``. It names a
configuration ``configs/<config>.json`` (the preset's fields as run, its source,
what was reduced or assumed, the deployment it stands for) and a traffic mix
``traffic/<mix>.json`` (the parameters the generator in ``traffic.py`` reads,
and the driver kind, ``drivers/<kind>.py``).

Which metrics a cell reports is read from ``BENCHMARK.json`` alone: an
end-to-end metric whose ``workloads`` name the cell (or that has none, as
``setup_s``), and a per-layer metric whose ``workloads`` name it (or, without
the key, whose ``moves`` the cell reports). A metric's number is found by the
longest dotted prefix of its name: an end-to-end metric among what the
driver's window measured (``train_windows_per_s.scale_up`` reads the train
driver's ``train_windows_per_s``), a per-layer metric in the reader
``metrics/<prefix>.py`` (``device_idle.serve`` reads ``metrics/device_idle.py``).
So a quantity split by cell, and a later cell, need only entries and files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent


def _load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT.parent)} is missing)")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return _load_json("workloads", name)


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def cell_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def driver(kind: str) -> ModuleType:
    """``drivers/<kind>.py``: ``setup(ctx)``, ``window(session, seconds)``,
    ``traced(session)`` and ``check(session)``."""
    if not (ROOT / "drivers" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no driver named {kind!r}")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def manifest() -> dict:
    with open(ROOT.parent / "BENCHMARK.json") as f:
        return json.load(f)


def _names_cell(entry: dict, cell_name: str) -> bool:
    return cell_name in entry.get("workloads", ())


def end_to_end_of(cell_name: str) -> list[dict]:
    """The ``end_to_end`` entries this cell reports."""
    return [m for m in manifest()["end_to_end"] if "workloads" not in m or _names_cell(m, cell_name)]


def per_layer_of(cell_name: str) -> list[dict]:
    """The ``per_layer`` entries this cell's traced run reports."""
    reported = {m["name"] for m in end_to_end_of(cell_name)}
    return [m for m in manifest()["per_layer"]
            if _names_cell(m, cell_name) or ("workloads" not in m and m["moves"] in reported)]


def prefixes(name: str) -> list[str]:
    """``a.b.c`` -> ``a.b.c``, ``a.b``, ``a``."""
    parts = name.split(".")
    return [".".join(parts[:k]) for k in range(len(parts), 0, -1)]


def lookup(values: dict, name: str):
    """The value under the longest dotted prefix of ``name``, or None."""
    return next((values[p] for p in prefixes(name) if p in values), None)


def reader_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "metrics").glob("*.py") if not p.stem.startswith("_"))


def reader(name: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<prefix>.py`` for the
    longest dotted prefix of ``name`` that has a file (loaded by path, as a
    name may hold dots)."""
    for prefix in prefixes(name):
        path = ROOT / "metrics" / f"{prefix}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{prefix.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r} under metrics/")
