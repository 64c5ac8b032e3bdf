"""PyTorch port: the batched SARIMA baseline on its own (models/sarima.py,
ops/sarima.py), on the CPU and, in its ``cuda`` cases, on the card.

* The hand adjoint of the plain version (``css_backward_reference``) against
  torch autograd through the plain forward loop, within 1e-5 (both fp32,
  summed in other orders);
* the chunked mirror of the kernels' decomposition
  (``css_{forward,backward}_chunked_reference``) against the sequential
  plain versions, within 1e-5 of the largest value, over seasons 1, 4, 12
  and 23 and the edge cases the kernels meet (``CHUNKED_CASES``);
* the forecast kernels' ring mirror (``forecast_ring_mirror``) against the
  plain version within 1e-5 of the largest value at ``FORECAST_CASES``, and
  their launch plan (``forecast_plan``): every season up to ``MAX_SEASON``
  admitted within the card's shared memory;
* the JAX package's ``ValueError``s for a short series and a short window;
* the wrappers take the plain version for a CPU tensor only: a tensor off the
  CPU goes to the kernel, whose build raises here (no CUDA toolchain);
* ``sarima_baseline`` (statsmodels' SARIMAX) raises ``ImportError`` here, as
  JAX's does; ``create_features_and_targets`` is the two calls it wraps.

On the card (marked ``cuda``, skipped without one; there: ``python -m pytest
tests/test_torch_sarima.py -m cuda --noconftest``, as tests/conftest.py
imports JAX): the three kernels of csrc/sarima.cu against their plain
versions on card_cases.py's simulated flagship series (sarima_inputs), with
the loss and gradient through them and 3 Adam steps; the fit's kernels at
``FIT_EDGES`` and the forecast at ``FORECAST_EDGES`` (its launch plan from
the C entry equal to ``forecast_plan``), each twice for the same bits; and
the forecast at card_cases.SARIMA_FORECAST_LARGE windows.

The parity with the JAX package is tests/test_torch_sarima_jax.py."""

import ctypes
import functools

import numpy as np
import pytest
import torch

from tec_mollm_tpu_torch.data.features import build_split_tensors, create_features_and_targets
from tec_mollm_tpu_torch.data.hdf5_io import load_and_split_data
from tec_mollm_tpu_torch.data.synthetic import write_synthetic_hdf5
from tec_mollm_tpu_torch.models import baselines
from tec_mollm_tpu_torch.models.sarima import SarimaParams, adam_fit, fit_sarima, forecast_windows
from tec_mollm_tpu_torch.ops import _build
from tec_mollm_tpu_torch.ops import sarima as ops
import card_cases as cases
from torch_card import card  # noqa: F401 (card: a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _series(steps: int, nodes: int, season: int, seed: int = 0) -> torch.Tensor:
    """A differenced, per-node scaled seasonal random walk, as fit_sarima feeds the recursion."""
    rng = np.random.default_rng(seed)
    t = np.arange(steps)[:, None]
    x = np.sin(2 * np.pi * t / season) + 0.3 * rng.standard_normal((steps, nodes)).cumsum(axis=0)
    y = ops.difference(torch.tensor(x, dtype=torch.float32), season)
    return (y / y.std(dim=0, correction=0)).contiguous()


@pytest.mark.parametrize("season", [1, 4, 12])
def test_hand_adjoint_is_autograd_of_the_forward_loop(season):
    y = _series(80, 5, season)
    raw = torch.tensor(np.random.default_rng(1).normal(0, 0.5, (4, 5)), dtype=torch.float32, requires_grad=True)
    coeffs = 0.99 * torch.tanh(raw)
    count = (y.shape[0] - season - 1) * y.shape[1]
    _, partial = ops.css_forward_reference(y, coeffs, season)
    (partial.sum() / count).backward()
    loss, grad = ops.css_loss_and_grad(raw.detach(), y, season)
    assert loss.item() == pytest.approx((partial.sum() / count).item(), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), raw.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_adjoint_of_each_coefficient_is_autograd():
    """d (scale/2 sum e^2) / d coefficients, the kernel's own output, against autograd."""
    season, scale = 3, 0.37
    y = _series(50, 3, season, seed=2)
    coeffs = torch.tensor(np.random.default_rng(3).uniform(-0.8, 0.8, (4, 3)), dtype=torch.float32,
                          requires_grad=True)
    e, partial = ops.css_forward_reference(y, coeffs, season)
    (scale / 2 * partial.sum()).backward()
    got = ops.css_backward_reference(y, e.detach(), coeffs.detach(), season, scale)
    np.testing.assert_allclose(got.numpy(), coeffs.grad.numpy(), atol=1e-5, rtol=1e-5)


# (season, T, N, chunk): chunks that do not divide T, the kernels' chunk of 33,
# one chunk longer than T, chunks shorter than the season (a residue class
# missing from some chunks), N not a multiple of the kernels' node tile of 8,
# and T below season + 1 (no term in the loss)
CHUNKED_CASES = [
    (1, 80, 5, 7), (1, 80, 3, 100), (4, 80, 19, 13), (4, 61, 5, 33), (12, 80, 5, 33), (12, 94, 17, 33),
    (12, 60, 3, 100), (12, 50, 3, 5), (23, 90, 3, 25), (23, 90, 3, 33), (23, 10, 4, 4), (12, 12, 3, 33),
]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the largest magnitude (the difference itself where want is all 0)."""
    diff, top = float((got - want).abs().max()), float(want.abs().max())
    return diff / top if top > 0 else diff


@pytest.mark.parametrize("season, steps, nodes, chunk", CHUNKED_CASES)
def test_chunked_mirror_is_the_sequential_recursion(season, steps, nodes, chunk):
    """The kernels' decomposition (factored stages, chunk-local solutions,
    carries by residue class, fix-up) against the sequential plain versions:
    e, partial and the (4, N) gradient within 1e-5 of the largest value
    (both fp32, summed in other orders). Nodes 0 and 1 sit at +-0.99."""
    rng = np.random.default_rng(season * 1000 + steps)
    y = torch.tensor(rng.standard_normal((steps, nodes)), dtype=torch.float32)
    c = rng.uniform(-0.9, 0.9, (4, nodes))
    c[:, 0], c[:, 1] = (0.99, -0.99, 0.99, -0.99), (-0.99, 0.99, -0.99, 0.99)
    coeffs = torch.tensor(c, dtype=torch.float32)
    e, partial = ops.css_forward_reference(y, coeffs, season)
    e_c, partial_c = ops.css_forward_chunked_reference(y, coeffs, season, chunk)
    grad = ops.css_backward_reference(y, e, coeffs, season, 0.37)
    grad_c = ops.css_backward_chunked_reference(y, e, coeffs, season, 0.37, chunk)
    assert e_c.shape == e.shape == (steps, nodes) and grad_c.shape == (4, nodes)
    for name, got, want in (("e", e_c, e), ("partial", partial_c, partial), ("grad", grad_c, grad)):
        assert _rel(got, want) <= 1e-5, name
    if steps < season + 1:
        assert not partial_c.any() and not grad_c.any()


# (windows, L, N, season, horizon): the compile-time form's shape, the
# card's forecast edges (FORECAST_EDGES) at a few nodes (a node count below a warp at
# season 1, the shortest window, season 23, seasons 302 and 528), and a window
# far longer than 2 (s + 1)
FORECAST_CASES = [
    (3, 48, 5, 12, 12), (5, 4, 37, 1, 3), (2, 26, 6, 12, 12), (2, 48, 5, 23, 12), (2, 606, 4, 302, 12),
    (2, 1060, 3, 528, 12), (2, 100, 3, 4, 7),
]


@pytest.mark.parametrize("windows, length, nodes, season, horizon", FORECAST_CASES)
def test_forecast_ring_mirror_is_the_plain_version(windows, length, nodes, season, horizon):
    """The forecast kernels' order (each row taken once into a ring of the
    last s + 1 levels, y formed from it, y and e in rings of the same slots)
    against forecast_reference, within 1e-5 of the largest value."""
    rng = np.random.default_rng(length * 100 + season)
    x = torch.tensor(rng.standard_normal((windows, length, nodes)).cumsum(axis=1), dtype=torch.float32)
    coeffs = torch.tensor(0.99 * np.tanh(rng.normal(0, 0.5, (4, nodes))), dtype=torch.float32)
    want = ops.forecast_reference(x, coeffs, horizon, season)
    got = ops.forecast_ring_mirror(x, coeffs, horizon, season)
    assert got.shape == want.shape == (windows, horizon, nodes)
    assert _rel(got, want) <= 1e-5


def test_forecast_plan_admits_every_season():
    """Every season the fit takes gets the ring form in whole warps (at most
    FORECAST_THREADS a block) within the card's 232,448-byte opt-in limit,
    one warp at the largest; only the shipped shape gets the compile-time form."""
    assert ops.forecast_plan(*ops.FIXED_SHAPE) == (1, ops.FORECAST_THREADS, 0)
    for season in range(1, ops.MAX_SEASON + 1):
        for length, horizon in ((2 * (season + 1), 12), (2 * (season + 1) + 7, 1)):
            plan = ops.forecast_plan(length, season, horizon)
            assert plan.fixed == 0 and 32 <= plan.threads <= ops.FORECAST_THREADS and plan.threads % 32 == 0
            assert plan.smem == plan.threads * 3 * (season + 1) * 4 <= 232_448
    assert ops.forecast_plan(2 * (ops.MAX_SEASON + 1), ops.MAX_SEASON, 12).threads == 32
    assert ops.forecast_plan(48, 12, 11).fixed == 0 and ops.forecast_plan(49, 12, 12).fixed == 0


def test_the_jax_guards():
    with pytest.raises(ValueError, match="too short"):
        fit_sarima(np.zeros((20, 2)), season=12, device="cpu")
    rng = np.random.default_rng(4)
    params = fit_sarima(rng.standard_normal((60, 2)).cumsum(axis=0), season=4, steps=3, device="cpu")
    with pytest.raises(ValueError, match="L_in"):
        forecast_windows(params, np.zeros((2, 8, 2)), L_out=4, season=4, device="cpu")


def test_forecast_keeps_the_callers_array_kind():
    """numpy in, numpy out (the JAX contract); a tensor stays a tensor."""
    params = SarimaParams(*(np.full(3, v, np.float32) for v in (0.5, 0.2, -0.3, -0.1)))
    wins = np.random.default_rng(5).standard_normal((2, 12, 3)).astype(np.float32)
    got = forecast_windows(params, wins, L_out=4, season=4, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (2, 4, 3)
    again = forecast_windows(params, torch.from_numpy(wins), L_out=4, season=4)
    assert isinstance(again, torch.Tensor)
    np.testing.assert_array_equal(again.numpy(), got)


def test_forecast_of_a_pure_seasonal_cycle_repeats_it():
    """All coefficients 0: y = 0 ahead, so x_t = x_{t-1} + x_{t-s} - x_{t-s-1}
    continues a cycle of period s exactly."""
    s = 4
    cycle = np.array([1.0, 3.0, 2.0, 5.0], np.float32)
    wins = np.tile(cycle, 3)[None, :, None] + np.float32(10.0)
    params = SarimaParams(*(np.zeros(1, np.float32) for _ in range(4)))
    got = forecast_windows(params, wins, L_out=8, season=s, device="cpu")
    np.testing.assert_allclose(got[0, :, 0], np.tile(cycle, 2) + 10.0, atol=1e-5)


def test_a_device_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises: without a CUDA
    toolchain the build raises, never the plain version."""
    y = torch.empty(30, 4, device="meta")
    coeffs = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="coeffs"):
        ops.css_forward(y, torch.empty(3, 4, device="meta"), 4)
    if not torch.cuda.is_available():
        for call in (lambda: ops.css_forward(y, coeffs, 4),
                     lambda: ops.css_backward(y, y, coeffs, 4, 1.0),
                     lambda: ops.forecast(torch.empty(2, 12, 4, device="meta"), coeffs, 3, 4)):
            with pytest.raises(RuntimeError, match="nvcc|CUDA"):
                call()


def test_the_fit_kernels_refuse_a_season_past_their_largest():
    """On the card the fit's kernels take seasons up to MAX_SEASON (their
    segment holds the carry rows); the plain version takes any."""
    s = ops.MAX_SEASON + 1
    y, coeffs = torch.empty(s + 10, 4, device="meta"), torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="seasons up to"):
        ops.css_forward(y, coeffs, s)
    with pytest.raises(ValueError, match="seasons up to"):
        ops.css_backward(y, y, coeffs, s, 1.0)
    e, partial = ops.css_forward(torch.zeros(s + 3, 2), torch.zeros(4, 2), s)
    assert e.shape == (s + 3, 2) and float(partial.abs().max()) == 0.0


def test_the_forecast_refuses_a_season_past_the_largest():
    """On the card the forecast takes the fit's seasons, up to MAX_SEASON, and
    refuses a larger one before any launch; the plain version takes any."""
    s = ops.MAX_SEASON + 1
    coeffs = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="seasons up to"):
        ops.forecast(torch.empty(2, 2 * (s + 1), 4, device="meta"), coeffs, 3, s)
    got = ops.forecast(torch.zeros(2, 2 * (s + 1), 4), torch.zeros(4, 4), 3, s)
    assert got.shape == (2, 3, 4) and float(got.abs().max()) == 0.0


def test_sarima_baseline_needs_statsmodels():
    try:
        import statsmodels  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="statsmodels is not available"):
            baselines.sarima_baseline()
    else:
        assert hasattr(baselines.sarima_baseline(), "fit")


def test_create_features_and_targets_is_the_two_steps(tmp_path):
    paths = []
    for year, seed in ((2020, 0), (2022, 1), (2024, 2)):
        paths.append(str(tmp_path / f"tec_{year}.h5"))
        write_synthetic_hdf5(paths[-1], year=year, num_steps=40, grid_h=4, grid_w=5, seed=seed)
    got = create_features_and_targets(paths, horizon=6)
    want = build_split_tensors(load_and_split_data(paths), 6)
    assert set(got) == set(want) == {"train", "val", "test"}
    for split in want:
        assert set(got[split]) == set(want[split])
        for k in want[split]:
            np.testing.assert_array_equal(got[split][k], want[split][k], err_msg=f"{split}/{k}")


# ---------------------------------------------------------------- the card
# The kernels against their plain versions: each output's largest difference
# over its largest magnitude within card_cases.SARIMA_RTOL; the raw parameters
# after 3 Adam steps within ADAM_ATOL. A step moves a raw parameter by lr * m /
# (sqrt(v) + eps), about lr = 0.05 where its gradient is large; where a node's gradient
# is near eps = 1e-8 (the loss is a mean over 2911 nodes, so a gradient is
# ~1e-4 at most), a gradient difference d moves the step by up to lr * d /
# (4 eps), about 4e-4 for d = 1e-6 of the largest gradient: three steps stay
# within 1e-3, where a wrong gradient moves the parameters by ~lr.
ADAM_ATOL = 1e-3
# the fit kernels' edge shapes (T, N, season): the test CLI's 94-step fit, a
# node count below one tile at season 1, the CLI's largest season at L_in 48,
# and T below season + 1 (no loss term)
FIT_EDGES = [(94, 2911, 12), (1987, 37, 1), (500, 2911, 23), (10, 2911, 12)]
# the forecast's edge shapes (windows, L, N, season, horizon): the eval CLI's
# last partial batch (91 test windows), one window (the flagship's L, season
# and horizon), a node count below a warp at season 1, the shortest window at
# season 12, the CLI's largest season at L_in 48, and seasons 302 and 528 (one
# warp a block: its rings fill shared memory)
FORECAST_EDGES = [(27, 48, 2911, 12, 12), (1, 48, 2911, 12, 12), (5, 4, 37, 1, 3), (8, 26, 2911, 12, 12),
                  (8, 48, 2911, 23, 12), (2, 606, 64, 302, 12), (2, 1060, 64, 528, 12)]


@functools.cache
def _flagship(device) -> dict:
    """card_cases.sarima_inputs: the simulated (2000, 2911) series, y, coefficients, 64 windows."""
    return cases.sarima_inputs(0, device)


def _c_plan(length: int, season: int, horizon: int) -> ops.ForecastPlan:
    """The forecast's launch plan for a call, from the C entry sarima_forecast_plan."""
    out = (ctypes.c_longlong * len(ops.ForecastPlan._fields))()
    fn = _build.function("sarima_forecast_plan", ops.FORECAST_PLAN_ARGTYPES)
    _build.check("sarima_forecast_plan", fn(length, season, horizon, ctypes.cast(out, ctypes.c_void_p)))
    return ops.ForecastPlan(*out)


@pytest.mark.cuda
def test_card_kernels_match_the_plain_versions_at_the_flagship(card):
    """The three kernels and the loss and gradient through them, on the
    simulated series at season 12; two launches on the same inputs give the
    same bits."""
    f = _flagship(card)
    y, coeffs, s, scale, wins, horizon = (f[k] for k in ("y", "coeffs", "season", "scale", "wins", "horizon"))
    e, partial = ops.css_forward(y, coeffs, s)
    e_p, partial_p = ops.css_forward_reference(y, coeffs, s)
    grad = ops.css_backward(y, e, coeffs, s, scale)
    fc = ops.forecast(wins, coeffs, horizon, s)
    (loss, grad_raw), (loss_p, grad_raw_p) = (ops.css_loss_and_grad(f["raw"], y, s),
                                              ops.css_loss_and_grad_reference(f["raw"], y, s))
    for name, got, want in (("e", e, e_p), ("partial", partial, partial_p),
                            ("grad", grad, ops.css_backward_reference(y, e_p, coeffs, s, scale)),
                            ("forecast", fc, ops.forecast_reference(wins, coeffs, horizon, s)),
                            ("loss", loss, loss_p), ("grad_raw", grad_raw, grad_raw_p)):
        assert _rel(got, want) <= cases.SARIMA_RTOL, name
    again = (*ops.css_forward(y, coeffs, s), ops.css_backward(y, e, coeffs, s, scale),
             ops.forecast(wins, coeffs, horizon, s))
    assert all(torch.equal(a, b) for a, b in zip(again, (e, partial, grad, fc)))


@pytest.mark.cuda
def test_card_adam_steps_through_the_kernels(card):
    f = _flagship(card)
    got = adam_fit(f["y"], f["season"], 3)
    want = adam_fit(f["y"], f["season"], 3, loss_and_grad=ops.css_loss_and_grad_reference)
    assert float((got - want).abs().max()) <= ADAM_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("steps, nodes, season", FIT_EDGES)
def test_card_fit_kernels_at_the_edges(card, steps, nodes, season):
    """Slices of the flagship's y and coefficients, twice for the same bits;
    below season + 1 steps no term: partial and gradient 0."""
    f = _flagship(card)
    y, coeffs = f["y"][:steps, :nodes].contiguous(), f["coeffs"][:, :nodes].contiguous()
    scale = 2.0 / (max(steps - season - 1, 1) * nodes)
    (e, partial), (e2, partial2) = ops.css_forward(y, coeffs, season), ops.css_forward(y, coeffs, season)
    e_p, partial_p = ops.css_forward_reference(y, coeffs, season)
    grad, grad2 = ops.css_backward(y, e_p, coeffs, season, scale), ops.css_backward(y, e_p, coeffs, season, scale)
    assert _rel(e, e_p) <= cases.SARIMA_RTOL and _rel(partial, partial_p) <= cases.SARIMA_RTOL
    assert _rel(grad, ops.css_backward_reference(y, e_p, coeffs, season, scale)) <= cases.SARIMA_RTOL
    assert torch.equal(e, e2) and torch.equal(partial, partial2) and torch.equal(grad, grad2)
    if steps < season + 1:
        assert not partial.any() and not grad.any()


@pytest.mark.cuda
@pytest.mark.parametrize("windows, length, nodes, season, horizon", FORECAST_EDGES)
def test_card_forecast_at_the_edges(card, windows, length, nodes, season, horizon):
    """Windows of the flagship series, twice for the same bits; the C entry
    plans the launch as ops/sarima.py:forecast_plan does."""
    f = _flagship(card)
    x = cases.sarima_windows(f["series"][:, :nodes], windows, length, card)
    coeffs = f["coeffs"][:, :nodes].contiguous()
    got, again = ops.forecast(x, coeffs, horizon, season), ops.forecast(x, coeffs, horizon, season)
    assert _rel(got, ops.forecast_reference(x, coeffs, horizon, season)) <= cases.SARIMA_RTOL
    assert torch.equal(got, again) and bool(got.isfinite().all())
    assert _c_plan(length, season, horizon) == ops.forecast_plan(length, season, horizon)


@pytest.mark.cuda
def test_card_forecast_at_many_windows(card):
    f = _flagship(card)
    wins = cases.sarima_windows(f["series"], cases.SARIMA_FORECAST_LARGE, f["L_in"], card)
    got = ops.forecast(wins, f["coeffs"], f["horizon"], f["season"])
    assert _rel(got, ops.forecast_reference(wins, f["coeffs"], f["horizon"], f["season"])) <= cases.SARIMA_RTOL
