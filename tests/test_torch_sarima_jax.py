"""PyTorch port: the batched SARIMA baseline against the JAX package's, on the
same numpy inputs, on the CPU (the port's plain versions of its kernels).

Tolerances:

* ``forecast_windows`` with the same coefficients, at seasons 1 to 528: 1e-5
  relative to the largest forecast (both fp32, the same recursion);
* the CSS loss and its gradient (the port's hand adjoint) against
  ``jax.value_and_grad`` of JAX's objective: 1e-5 relative;
* the same through the kernels' chunked decomposition
  (``css_loss_and_grad_chunked_reference``): 1e-5 relative;
* the coefficients after 5 Adam steps (torch's Adam, optax's defaults):
  1e-5 (measured here: 6.0e-7);
* after a whole short fit (T = 600, N = 4, s = 4, 300 steps): 1e-4. Measured
  on this data: the two fits end 4.2e-7 apart at most (the gap stays at the
  rounding of fp32 sums; 1e-4 leaves two orders of room for another
  machine's summation order);
* ``evaluate_sarima_streaming`` on the JAX test's tiny split, and the
  ``SARIMA`` row of ``run_evaluation`` and of the test CLI's CSV: 1e-4
  relative (the HA rows of the same call are tests/test_torch_eval_jax.py's).

A file of its own, so that the test workers run its JAX compiles beside the
port's other tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sarima import _simulate_sarima
from test_torch_eval import save_run, tiny, write_eval_dir

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu.evaluation.harness as jax_harness
import tec_mollm_tpu.models.sarima as jsarima
from tec_mollm_tpu.data.dataset import SlidingWindowDataset as JaxDataset
from tec_mollm_tpu.data.scaler import StandardScaler as JaxScaler
from tec_mollm_tpu_torch import test as test_cli
from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler
from tec_mollm_tpu_torch.evaluation import harness
from tec_mollm_tpu_torch.models import sarima
from tec_mollm_tpu_torch.ops import sarima as ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEYS = ("mae_avg", "rmse_avg", "r2_score_avg", "pearson_r_avg", "mae_by_horizon", "rmse_by_horizon")
COEFFS = ("phi", "sphi", "theta", "stheta")


def _raw(nodes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.5, (4, nodes)).astype(np.float32)


def _params(mod, raw: np.ndarray):
    return mod.SarimaParams(*(0.99 * np.tanh(raw[i]) for i in range(4)))


@pytest.mark.parametrize("season", [1, 4, 12, 23, 302, 528])
def test_forecast_windows_matches_jax(season):
    """Windows of 2 (s + 1) + 6 steps at 5 nodes, from season 1 to the
    kernels' largest (528), past the seasons the card once refused (302 up)."""
    x = _simulate_sarima(max(200, 2 * (season + 1) + 90), 5, season, 0.5, 0.3, -0.4, -0.2, seed=3)
    raw = _raw(5, season)
    wins = np.stack([x[40 + 7 * k : 40 + 7 * k + 2 * (season + 1) + 6] for k in range(6)])
    want = jsarima.forecast_windows(_params(jsarima, raw), wins, L_out=9, season=season)
    got = sarima.forecast_windows(_params(sarima, raw), wins, L_out=9, season=season, device="cpu")
    assert got.shape == want.shape == (6, 9, 5)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("season", [4, 12])
def test_css_loss_and_gradient_match_jax(season):
    """The port's loss and hand adjoint against jax.value_and_grad of the
    objective fit_sarima minimises, at random coefficients."""
    x = _simulate_sarima(300, 6, season, 0.5, 0.3, -0.4, -0.2)
    raw = _raw(6, 7)
    y = jsarima._difference(jnp.asarray(x, jnp.float32), season)
    y = y / jnp.maximum(jnp.std(y, axis=0), 1e-6)

    def loss_fn(r):
        c = 0.99 * jnp.tanh(r)
        eps = jsarima._innovations((c[0], c[1], c[2], c[3]), y, season)
        return jnp.mean(eps[season + 1 :] ** 2)

    want_loss, want_grad = jax.value_and_grad(loss_fn)(jnp.asarray(raw))
    yt = ops.difference(torch.tensor(x, dtype=torch.float32), season)
    yt = (yt / yt.std(dim=0, correction=0).clamp_min(1e-6)).contiguous()
    loss, grad = ops.css_loss_and_grad(torch.from_numpy(raw), yt, season)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(grad.numpy(), want_grad, atol=1e-5 * np.abs(want_grad).max())


@pytest.mark.parametrize("season", [4, 12])
def test_chunked_mirror_loss_and_gradient_match_jax(season):
    """The kernels' chunked decomposition (chunks of 33 steps, the kernels'
    length) against jax.value_and_grad of JAX's objective, within 1e-5."""
    x = _simulate_sarima(300, 6, season, 0.5, 0.3, -0.4, -0.2, seed=2)
    raw = _raw(6, 11)
    y = jsarima._difference(jnp.asarray(x, jnp.float32), season)
    y = y / jnp.maximum(jnp.std(y, axis=0), 1e-6)

    def loss_fn(r):
        c = 0.99 * jnp.tanh(r)
        eps = jsarima._innovations((c[0], c[1], c[2], c[3]), y, season)
        return jnp.mean(eps[season + 1 :] ** 2)

    want_loss, want_grad = jax.value_and_grad(loss_fn)(jnp.asarray(raw))
    yt = ops.difference(torch.tensor(x, dtype=torch.float32), season)
    yt = (yt / yt.std(dim=0, correction=0).clamp_min(1e-6)).contiguous()
    loss, grad = ops.css_loss_and_grad_chunked_reference(torch.from_numpy(raw), yt, season, 33)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(grad.numpy(), want_grad, atol=1e-5 * np.abs(want_grad).max())


def test_innovations_match_jax():
    season = 4
    y = np.random.default_rng(8).standard_normal((40, 3)).astype(np.float32)
    c = 0.99 * np.tanh(_raw(3, 9))
    want = jsarima._innovations(tuple(jnp.asarray(v) for v in c), jnp.asarray(y), season)
    got = sarima._innovations(torch.from_numpy(c), torch.from_numpy(y), season)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("steps, tol", [(5, 1e-5), (300, 1e-4)])
def test_fit_matches_jax(steps, tol):
    """5 Adam steps, then a whole short fit (T = 600, N = 4, s = 4)."""
    x = _simulate_sarima(600, 4, 4, 0.5, 0.3, -0.4, -0.2, seed=1)
    want = jsarima.fit_sarima(x, season=4, steps=steps)
    got = sarima.fit_sarima(x, season=4, steps=steps, device="cpu")
    for k in COEFFS:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), atol=tol, err_msg=k)
        assert getattr(got, k).dtype == np.float32


def _tiny_split(rng):
    """tests/test_sarima.py's harness split: a seasonal cycle of period 4 and
    a slow random walk, feature-scaled by (40, 8) and target-scaled by (40, 7)."""
    s, T, N, L_in, L_out = 4, 120, 6, 16, 4
    x_phys = 40 + 8 * np.sin(2 * np.pi * np.arange(T) / s)[:, None] + rng.normal(0, 1, (T, N)).cumsum(axis=0) * 0.1
    x_fs = (x_phys - 40.0) / 8.0
    y_ts = np.zeros((T, N, L_out), np.float32)
    for t in range(T - L_out):
        y_ts[t] = ((x_phys[t + 1 : t + 1 + L_out] - 40.0) / 7.0).T
    arrays = {"X": x_fs[..., None].astype(np.float32), "Y": y_ts, "time_features": np.zeros((T, 4), np.int32)}
    return arrays, x_fs, L_in, L_out


def test_evaluate_sarima_streaming_matches_jax():
    arrays, x_fs, L_in, L_out = _tiny_split(np.random.default_rng(0))
    kw = dict(season=4, fit_steps=100, fit_window=100)

    def scalers(cls):
        f, t = cls(), cls()
        f.mean_, f.scale_, t.mean_, t.scale_ = np.array([40.0]), np.array([8.0]), np.array([40.0]), np.array([7.0])
        return f, t

    want = jax_harness.evaluate_sarima_streaming(
        JaxDataset(arrays, L_in=L_in, L_out=L_out, stride=1), x_fs[:100], L_out, *scalers(JaxScaler), **kw)
    got = harness.evaluate_sarima_streaming(
        SlidingWindowDataset(arrays, L_in=L_in, L_out=L_out, stride=1), x_fs[:100], L_out, *scalers(StandardScaler),
        device="cpu", **kw)
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["mae_avg"] < 4.0  # the JAX test's bound: far below the 8-TECU seasonal amplitude


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    return write_eval_dir(str(tmp_path_factory.mktemp("sarimajax") / "proc"), tiny())


def _csv_row(path, name):
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    return {r[0]: np.asarray(r[1:], np.float64) for r in rows[1:]}[name]


def test_sarima_row_of_run_evaluation_and_the_cli_match_jax(proc, tmp_path):
    """The SARIMA row (season 4, the tiny config's L_in of 16 conditions at
    most s = 7) of the port's run_evaluation and test CLI against JAX's
    run_evaluation on the same checkpoint and processed dir."""
    path = save_run(tmp_path, "run", tiny(), 3)
    want = jax_harness.run_evaluation(tiny(jcfg), proc, path, output_dir=str(tmp_path / "jax"), batch_size=8,
                                      baselines=("sarima",), sarima_season=4)["results"]
    got = harness.run_evaluation(tiny(), proc, path, output_dir=str(tmp_path / "port"), batch_size=8,
                                 baselines=("sarima",), sarima_season=4, device="cpu")["results"]
    assert list(got) == list(want) == ["TEC-MoLLM", "HistoricalAverage", "SARIMA"]
    for k in KEYS:
        np.testing.assert_allclose(got["SARIMA"][k], want["SARIMA"][k], rtol=1e-4, err_msg=k)
    out = str(tmp_path / "cli")
    test_cli.main(["--cpu", "--data-dir", proc, "--workdir", str(tmp_path), "--checkpoint", path,
                   "--baseline", "sarima", "--sarima-season", "4", "--batch-size", "8", "--output-dir", out])
    csv = "evaluation_results.csv"
    np.testing.assert_allclose(_csv_row(os.path.join(out, csv), "SARIMA"),
                               _csv_row(str(tmp_path / "jax" / csv), "SARIMA"), rtol=1e-4, atol=2e-6)
