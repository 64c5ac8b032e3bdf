"""The harness end to end on the CPU at tiny sizes: every driver through the
in-process entry, the result line, the refusal without a card, a multi-chip
cell taken from its file alone, and the faults that must turn ``correct``
false."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, spec

ROOT = Path(__file__).resolve().parent.parent.parent
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(tiny, name, trace=False, seconds=1.0, seed=20260417):
    return harness.run_cell(name, seed, seconds, trace, device="cpu", overrides=tiny, log=lambda *a, **k: None)


@pytest.mark.parametrize("name", spec.cell_names())
def test_each_cell_runs_through_the_in_process_entry(tiny, name):
    line = run(tiny, name, trace=True)
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) <= {m["name"] for m in spec.per_layer_of(name)}
    assert json.loads(harness.dumps(line)) == line


@pytest.mark.parametrize("name", spec.cell_names())
def test_untraced_line_has_the_cell_end_to_end_metrics_and_setup(tiny, name):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    line = run(tiny, name)
    assert list(line) == CONTRACT_KEYS + ["checks"]
    want = {m["name"] for m in manifest["end_to_end"] if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    assert all(m["unit"] == units[k] for k, m in line["metrics"].items())


def test_the_command_refuses_without_a_card(tmp_path):
    """No card here: exit non-zero with no result, in the checkout and in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    assert not torch.cuda.is_available()
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "scale_up-train", "--seed", "3",
                              "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


def test_a_multi_chip_cell_is_taken_from_its_file_alone(tmp_path, tiny):
    """A new cell file with ``chips: 4`` and new entries in BENCHMARK.json,
    no file of the harness changed: four gloo ranks of the train driver meet
    at a file store, rank 0 gathers their rows and dropout masks for the
    check and prints the one line, with the cell's own metric."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    cell = {"name": "scale_up-train4", "config": "scale_up", "traffic": "epochs-64", "chips": 4,
            "why": "test", "limits": spec.cell("scale_up-train")["limits"]}
    (bench / "workloads" / "scale_up-train4.json").write_text(json.dumps(cell))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
    manifest["end_to_end"].append({"name": "train_windows_per_s.scale_up4", "unit": "windows/s", "better": "higher",
                                   "bound": 0.25, "source": "host_clock", "workloads": ["scale_up-train4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    over = {**tiny, "traffic": {**tiny["traffic"], "train_windows": 48}}
    (tmp_path / "tiny.json").write_text(json.dumps(over))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "scale_up-train4", "--seed", "11",
                          "--seconds", "1", "--trace", "0", "--device", "cpu", "--override", "tiny.json"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"train_windows_per_s.scale_up4", "setup_s"}
    assert line["correct"] is True, line["checks"]


@pytest.fixture
def broken_step(monkeypatch):
    """Patches the program's train step: ``kind`` 'unchanged' restores the
    parameters after each step, 'half' leaves the second half of each macro
    batch out of the mean."""
    from tec_mollm_tpu_torch.training import trainer as trainer_mod

    real = trainer_mod.make_train_step

    def patch(kind):
        def make(model, cfg):
            step = real(model, cfg)

            def broken(state, batch, graph, data=None):
                if kind == "half":
                    valid = batch["valid"].clone()
                    valid[len(valid) // 2:] = False
                    batch = {**batch, "valid": valid}
                    return step(state, batch, graph, data)
                saved = {k: p.detach().clone() for k, p in state.trainable().items()}
                state, metrics = step(state, batch, graph, data)
                with torch.no_grad():
                    for k, p in state.trainable().items():
                        p.copy_(saved[k])
                return state, metrics

            return broken

        monkeypatch.setattr(trainer_mod, "make_train_step", make)

    return patch


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(tiny, broken_step, kind):
    broken_step(kind)
    line = run(tiny, "scale_up-train")
    assert line["correct"] is False


@pytest.mark.parametrize("name", ["flagship-forecast", "flagship-serve"])
def test_an_altered_answer_is_not_correct(tiny, monkeypatch, name):
    from tec_mollm_tpu_torch.models import tec_mollm

    real = tec_mollm.TECMoLLM.forward

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        return out + 0.5 if not self.training else out

    monkeypatch.setattr(tec_mollm.TECMoLLM, "forward", altered)
    line = run(tiny, name)
    assert line["correct"] is False


@pytest.mark.parametrize("change", ["one_dropout_a_pair", "one_dropout_over_the_probabilities"])
def test_the_train_check_follows_the_program_masks_however_drawn(tiny, monkeypatch, change):
    """The reference takes the masks the program applied, so a program that
    draws them another way (one ``F.dropout`` a (query, key) pair in place of
    a generator each, or one dropout over all the attention probabilities)
    still reads correct."""
    import torch.nn.functional as F

    from tec_mollm_tpu_torch.models import gpt2

    if change == "one_dropout_a_pair":
        monkeypatch.setattr(gpt2, "split_dropout", lambda x, p, training, split: F.dropout(x, p, training))
    else:
        monkeypatch.setattr(gpt2, "unrolled_causal_attention", gpt2._einsum_causal_attention)
    line = run(tiny, "scale_up-train")
    assert line["correct"] is True, line["checks"]


def test_a_train_step_that_drops_nothing_is_not_correct(tiny, monkeypatch):
    """The reference follows the masks the program applied, and the masks are
    held to the configured rate: a program whose ``F.dropout`` keeps every
    unit reads not correct."""
    import torch.nn.functional as F

    real = F.dropout
    monkeypatch.setattr(F, "dropout", lambda x, p=0.5, training=True, inplace=False: real(x, p, False))
    line = run(tiny, "scale_up-train")
    assert line["correct"] is False
    assert line["checks"]["drop_rate_gap"]["value"] > 0.5
