"""PyTorch port: its ``run_evaluation`` and ``run_prediction`` against the JAX
package's, on the same ``best_params.pt`` and the same processed dir.

The port writes the checkpoint; the JAX package reads it through its own
reference importer (``.pt`` paths go to ``ref_import`` in its
``run_evaluation``; its ``run_prediction`` restores orbax checkpoints only, so
the test hands it the same importer). The eval batch is 8, a multiple of the
8 virtual devices the JAX tests run on, so both packages see the same batches
(the adaptive conformal pass works batch by batch). Tolerances:

* point model: every result within 1e-4 relative (the CSV numbers also within
  one unit of their sixth decimal); the HA rows' MAE and RMSE within 1e-6.
  The HA rows' R^2 and Pearson r are held to 1e-5: they come from the
  per-horizon sums through differences that cancel, and each package sums a
  batch in fp32 in its own order. On this data the JAX package's HA Pearson r
  lies up to 3.2e-6 from the float64 value of ``evaluate_horizons``, the
  port's 6.4e-7, and the two 3.3e-6 apart;
* quantile + RevIN model, ``--conformal fit`` on val then adaptive on test:
  offsets within one bin (0.1 TECU), raw, calibrated and adaptive coverage
  within 2e-3;
* ``forecast.npz`` within 1e-4.

A file of its own, so that the test workers run its JAX compiles beside the
port's other evaluation tests."""

import os
import shutil

import numpy as np
import pytest
from test_torch_eval import LEVELS, save_run, tiny, write_eval_dir

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu.evaluation.harness as jax_harness
from tec_mollm_tpu.models.ref_import import load_reference_checkpoint
from tec_mollm_tpu_torch.evaluation import harness
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH = 8
METRIC_KEYS = ("mae_avg", "rmse_avg", "r2_score_avg", "pearson_r_avg",
               "mae_by_horizon", "rmse_by_horizon", "r2_by_horizon", "pearson_by_horizon")


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    return write_eval_dir(str(tmp_path_factory.mktemp("evaljax") / "proc"), tiny())


def _both(tmp_path, cfg_kwargs, seed):
    """The same best_params.pt in two run dirs (each package writes its own
    conformal.npz beside it); returns (port path, jax path, port cfg, jax cfg)."""
    path = save_run(tmp_path / "port", "run", tiny(**cfg_kwargs), seed)
    other = tmp_path / "jax" / "checkpoints" / "run"
    os.makedirs(other)
    shutil.copy(path, other / "best_params.pt")
    return path, str(other / "best_params.pt"), tiny(**cfg_kwargs), tiny(jcfg, **cfg_kwargs)


def _csv(path):
    with open(path) as f:
        header, *rows = [line.split(",") for line in f.read().splitlines()]
    return header, {r[0]: np.asarray(r[1:], dtype=np.float64) for r in rows}


def test_point_model_matches_jax_run_evaluation(proc, tmp_path):
    port_ck, jax_ck, pc, jc = _both(tmp_path, {}, seed=5)
    got = harness.run_evaluation(pc, proc, port_ck, output_dir=str(tmp_path / "port_out"), batch_size=BATCH,
                                 device="cpu")
    want = jax_harness.run_evaluation(jc, proc, jax_ck, output_dir=str(tmp_path / "jax_out"), batch_size=BATCH)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got["results"]["TEC-MoLLM"][k], want["results"]["TEC-MoLLM"][k], rtol=1e-4,
                                   err_msg=k)
        rtol = 1e-6 if k.startswith(("mae", "rmse")) else 1e-5
        np.testing.assert_allclose(got["results"]["HistoricalAverage"][k],
                                   want["results"]["HistoricalAverage"][k], rtol=rtol, err_msg=k)
    for k, v in want["improvements"].items():
        assert got["improvements"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    (h_got, rows_got), (h_want, rows_want) = (_csv(str(tmp_path / d / "evaluation_results.csv"))
                                              for d in ("port_out", "jax_out"))
    assert h_got == h_want and list(rows_got) == list(rows_want) == ["TEC-MoLLM", "HistoricalAverage"]
    for name in rows_want:
        np.testing.assert_allclose(rows_got[name], rows_want[name], rtol=1e-4, atol=1e-6, err_msg=name)
    for d in ("port_out", "jax_out"):
        assert sorted(os.listdir(tmp_path / d)) == ["evaluation_results.csv", "evaluation_summary.txt"]


def test_quantile_conformal_matches_jax_run_evaluation(proc, tmp_path):
    port_ck, jax_ck, pc, jc = _both(tmp_path, {"revin": True, "quantiles": LEVELS}, seed=6)
    kw = dict(batch_size=BATCH, conformal="fit", conformal_mode="adaptive")
    got = harness.run_evaluation(pc, proc, port_ck, output_dir=str(tmp_path / "port_out"), device="cpu", **kw)
    want = jax_harness.run_evaluation(jc, proc, jax_ck, output_dir=str(tmp_path / "jax_out"), **kw)
    with np.load(os.path.join(os.path.dirname(port_ck), "conformal.npz")) as a, \
            np.load(os.path.join(os.path.dirname(jax_ck), "conformal.npz")) as b:
        assert set(a.files) == set(b.files)
        np.testing.assert_allclose(a["offsets"], b["offsets"], rtol=0, atol=0.1)  # one bin
        assert str(a["mode"]) == str(b["mode"]) == "additive"
    g, w = got["results"]["TEC-MoLLM"], want["results"]["TEC-MoLLM"]
    for k in ("quantile_metrics", "quantile_metrics_conformal", "quantile_metrics_adaptive"):
        assert g[k]["interval_coverage"] == pytest.approx(w[k]["interval_coverage"], abs=2e-3), k
        np.testing.assert_allclose(g[k]["calibration_by_level"], w[k]["calibration_by_level"], atol=2e-3, err_msg=k)
    assert g["quantile_metrics_adaptive"]["adaptive"] == w["quantile_metrics_adaptive"]["adaptive"]
    for k in ("mae_by_horizon", "rmse_by_horizon"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for name in ("quantile_metrics.csv", "quantile_metrics_conformal.csv", "quantile_metrics_adaptive.csv"):
        (hg, rg), (hw, rw) = (_csv(str(tmp_path / d / name)) for d in ("port_out", "jax_out"))
        assert hg == hw and list(rg) == list(rw)


def test_run_prediction_matches_jax(proc, tmp_path, monkeypatch):
    port_ck, jax_ck, pc, jc = _both(tmp_path, {"revin": True, "quantiles": LEVELS}, seed=7)
    for ck in (port_ck, jax_ck):  # the same offsets beside both
        from tec_mollm_tpu_torch.evaluation.conformal import ConformalOffsets

        ConformalOffsets(LEVELS, np.random.default_rng(1).normal(size=(pc.train.L_out, 3))).save(
            ConformalOffsets.path_for(ck))
    monkeypatch.setattr(jax_harness, "load_params_for_eval",
                        lambda cfg, path, graph: load_reference_checkpoint(path, cfg.model))
    kw = dict(split="test", indices=[0, 3, 17])
    got = harness.run_prediction(pc, proc, port_ck, output_dir=str(tmp_path / "port_out"), device="cpu", **kw)
    want = jax_harness.run_prediction(jc, proc, jax_ck, output_dir=str(tmp_path / "jax_out"), **kw)
    with np.load(got["path"]) as a, np.load(want["path"]) as b:
        assert set(a.files) == set(b.files)
        assert "forecast_quantiles_conformal" in a.files
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)
