"""The benchmark's files: each is found by name, names only files that exist,
agrees with BENCHMARK.json, and imports nothing it must not."""

import ast
import json
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
JAX_NAMES = {"jax", "jaxlib", "flax", "tec_mollm_tpu"}


def imported_modules(path: Path) -> list[str]:
    """The module of every absolute import in a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


@pytest.mark.parametrize("name", spec.cell_names())
def test_cell_names_existing_files(name):
    cell = spec.cell(name)
    assert cell["name"] == name
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert config["name"] == cell["config"]
    assert spec.driver(traffic["driver"]).setup
    assert cell["chips"] in (1, 4)
    assert 0 < len(cell["why"]) <= 200
    entry = {w["name"]: w for w in MANIFEST["workloads"]}[name]
    assert {k: cell[k] for k in ("name", "config", "traffic", "chips", "why")} == entry


def test_manifest_names_only_files_there():
    assert MANIFEST["paths"] == ["benchmark"]
    assert sorted(w["name"] for w in MANIFEST["workloads"]) == spec.cell_names()
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}


@pytest.mark.parametrize("entry", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_and_moves_what_its_cells_report(entry):
    module = spec.reader(entry["name"])
    assert module.read({"window": {}, "config": {}, "device_kind": "cpu"}) is None
    assert set(entry["workloads"]) <= set(spec.cell_names())
    for cell in entry["workloads"]:
        assert entry["moves"] in {m["name"] for m in spec.end_to_end_of(cell)}
        assert entry in spec.per_layer_of(cell)


def test_every_reader_serves_a_metric_and_every_cell_has_metrics():
    used = {next(p for p in spec.prefixes(m["name"]) if p in spec.reader_names()) for m in MANIFEST["per_layer"]}
    assert used == set(spec.reader_names())
    for cell in spec.cell_names():
        names = [m["name"] for m in spec.end_to_end_of(cell)]
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer_of(cell)


def test_a_name_is_read_by_its_longest_prefix():
    assert spec.prefixes("a.b.c") == ["a.b.c", "a.b", "a"]
    assert spec.lookup({"train_windows_per_s": 3.0}, "train_windows_per_s.scale_up") == 3.0
    assert spec.lookup({"x": 1.0}, "y.x") is None
    assert spec.reader("device_idle.serve").__name__ == "benchmark.metrics.device_idle"


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_imports_jax_or_the_jax_package(path):
    """Each import's top-level name (before the first dot) compared whole:
    the program's name begins with the JAX package's."""
    assert not {m.split(".")[0] for m in imported_modules(path)} & JAX_NAMES


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """The reference imports neither the program nor the rest of the
    benchmark: plain torch, numpy and its own files."""
    mods = imported_modules(path)
    assert not [m for m in mods if m.split(".")[0] == "tec_mollm_tpu_torch"]
    assert all(m.startswith("benchmark.reference") for m in mods if m.split(".")[0] == "benchmark")
