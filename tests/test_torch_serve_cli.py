"""PyTorch port: the serve CLI on the eval side's checkpoint policy, and
conformal bands in ForecastService.

* ``--checkpoint latest`` and ``--run-name`` pick the run that the JAX
  package's ``resolve_cli_config`` picks from the same workdir (its
  checkpoints are ``best_params/`` directories, the port's
  ``best_params.pt`` files, with the same modification times), with that run's
  config.json;
* a quantile service with a ``conformal.npz`` beside its checkpoint returns
  ``forecast_quantiles_conformal`` equal (1e-12) to the JAX package's
  ``ConformalOffsets.apply_physical`` of the bands it returns; offsets of other
  levels are served raw, with the warning;
* ``--artifact`` serves an exported run and refuses one whose metadata
  disagrees with the config; without CUDA the CLI raises unless --cpu."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch
from test_torch_eval import LEVELS, save_run, tiny, write_eval_dir

import tec_mollm_tpu.evaluation.harness as jax_harness
from tec_mollm_tpu.evaluation.conformal import ConformalOffsets as JaxOffsets
from tec_mollm_tpu_torch import serve as serve_cli
from tec_mollm_tpu_torch.evaluation.conformal import ConformalOffsets
from tec_mollm_tpu_torch.serving import ForecastService
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    return write_eval_dir(str(tmp_path_factory.mktemp("serve_cli") / "proc"), tiny())


@pytest.fixture
def workdir(tmp_path):
    """Runs 'point' (older) and 'quant' (newer), each with a JAX-style
    best_params/ directory of the same age beside its best_params.pt."""
    for run, cfg, mtime in (("point", tiny(), 1_000_000), ("quant", tiny(revin=True, quantiles=LEVELS), 2_000_000)):
        save_run(tmp_path, run, cfg, seed=len(run), mtime=mtime)
        jax_dir = tmp_path / "checkpoints" / run / "best_params"
        os.makedirs(jax_dir)
        os.utime(jax_dir, (mtime, mtime))
    return tmp_path


@pytest.mark.parametrize("run_name", [None, "point", "quant"])
def test_latest_and_run_name_resolve_as_jax(workdir, run_name):
    from tec_mollm_tpu_torch.evaluation.harness import resolve_cli_config

    cfg, ck = resolve_cli_config(None, "latest", str(workdir), run_name)
    jcfg, jck = jax_harness.resolve_cli_config(None, "latest", str(workdir), run_name)
    assert os.path.dirname(ck) == os.path.dirname(jck) == str(workdir / "checkpoints" / (run_name or "quant"))
    assert cfg.model.quantiles == tuple(jcfg.model.quantiles) == (() if run_name == "point" else LEVELS)


def test_cli_serves_latest_of_a_workdir(proc, workdir, capsys):
    for run in (None, "point"):
        argv = ["--cpu", "--data-dir", proc, "--workdir", str(workdir), "--bench", "2"]
        serve_cli.main(argv + (["--run-name", run] if run else []))
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (out["requests"], out["device"], out["gat_route"]) == (2, "cpu", "kernel")


def test_conformal_bands_equal_jax_apply_physical(proc, workdir):
    ck = workdir / "checkpoints" / "quant" / "best_params.pt"
    offsets = np.random.default_rng(0).normal(0.0, 3.0, size=(tiny().train.L_out, 3))
    ConformalOffsets(LEVELS, offsets).save(ConformalOffsets.path_for(str(ck)))
    svc = ForecastService(tiny(revin=True, quantiles=LEVELS), proc, checkpoint="latest", workdir=str(workdir),
                          device="cpu", batch_window_ms=0)
    try:
        out = svc.forecast([0, 4])
    finally:
        svc.close()
    bands = np.asarray(out["forecast_quantiles"])
    want = JaxOffsets(LEVELS, offsets).apply_physical(bands)
    np.testing.assert_allclose(np.asarray(out["forecast_quantiles_conformal"]), want, rtol=1e-12, atol=0)
    assert not np.array_equal(want, bands)


def test_other_levels_are_served_raw_with_a_warning(proc, workdir, caplog):
    ck = workdir / "checkpoints" / "quant" / "best_params.pt"
    ConformalOffsets((0.05, 0.5, 0.95), np.zeros((tiny().train.L_out, 3))).save(ConformalOffsets.path_for(str(ck)))
    with caplog.at_level(logging.WARNING):
        svc = ForecastService(tiny(revin=True, quantiles=LEVELS), proc, checkpoint=str(ck), device="cpu",
                              batch_window_ms=0)
    try:
        out = svc.forecast([1])
    finally:
        svc.close()
    assert "forecast_quantiles" in out and "forecast_quantiles_conformal" not in out
    assert "serving raw bands" in caplog.text


def test_refusals(proc, workdir, monkeypatch, capsys, tmp_path):
    """--artifact serves an exported run (tests/test_torch_export.py holds its
    forecasts to the checkpoint's); an artifact whose metadata disagrees with
    the resolved config is refused, naming the field; without CUDA the CLI
    raises unless --cpu."""
    from tec_mollm_tpu_torch import export as export_cli

    common = ["--cpu", "--data-dir", proc, "--workdir", str(workdir)]
    art = export_cli.main(common + ["--run-name", "point", "--out", str(tmp_path / "point.pt2")])
    capsys.readouterr()
    serve_cli.main(common + ["--run-name", "point", "--artifact", art, "--bench", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["source"] == "artifact"
    other = tmp_path / "other.json"
    cfg = tiny()
    other.write_text(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, L_out=3)).to_json())
    with pytest.raises(ValueError, match="L_out"):
        serve_cli.main(common + ["--config", str(other), "--artifact", art, "--bench", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--data-dir", proc, "--workdir", str(workdir), "--bench", "1"])
