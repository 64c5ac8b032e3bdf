"""The batched SARIMA(1,1,1)x(1,1,1,s) recursions: CUDA kernels + plain versions.

No TPU kernel is replaced here. The JAX package runs the conditional-sum-of-
squares (CSS) innovations recursion as a ``lax.scan`` inside one jitted
program (``tec_mollm_tpu/models/sarima.py:_innovations``, differentiated by
``jax.value_and_grad`` in ``fit_sarima`` and stepped ahead in
``_forecast_jit``). Eager PyTorch would launch a few ops for each of ~2000
time steps, forward and backward, in each of 400 Adam steps; the kernels in
``csrc/sarima.cu`` make each pass one launch:

* ``css_forward``: the innovations e (T, N) of the differenced series y
  (T, N) under the coefficients (4, N) = (phi, Phi, theta, Theta), and each
  node's sum of e_t^2 over t >= s + 1;
* ``css_backward``: the hand adjoint of that sum, backwards in t, giving
  d(scale/2 * sum e^2)/d coefficients (4, N);
* ``forecast`` (one thread a (window, node)): the recursion over each
  window's history, then ``L_out`` steps ahead with future innovations 0 and
  the double difference inverted. Each window row is read once: the shipped
  shape (``FIXED_SHAPE``) has a compile-time form, unrolled with its rings in
  registers; every other shape takes a ring form whose three rings of s + 1
  slots lie in shared memory, a block sized at launch by ``forecast_plan``.
  ``forecast_ring_mirror`` is the plain mirror of its ring arithmetic.

The fit's two kernels scan time in chunks: (1 + theta B)(1 + Theta B^s) e = a
factors into a lag-1 and a lag-s first-order recursion (the adjoint: the same
in reversed time), each solved chunk by chunk from a zero start, the carries
then walked across the chunks for each residue class of the lag, and every
row fixed up by a power of the coefficient times its carry. A block owns 8
nodes and 16 chunks of 33 steps, a thread each; ``chunked_lag_solve`` and
``css_{forward,backward}_chunked_reference`` are the plain mirror of that
decomposition (any chunk length), which the CPU tests hold against the
sequential versions. The kernels take seasons up to ``MAX_SEASON``.

Their bound on this card is bytes (a fit step at T = 1987, N = 2911 moves
92.6 MB, 27.6 us at 3.35 TB/s; ``PERF.md`` has their times). The plain
versions compute the same math vectorised over nodes (and windows) with a
Python loop over time: the CPU's path, and what the ``cuda`` cases of
``tests/test_torch_sarima.py`` hold the kernels against. A CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tec_mollm_tpu_torch.ops import _build

FORWARD, BACKWARD, FORECAST = "sarima_css", "sarima_css_bwd", "sarima_forecast"
# the C entries' arguments: sarima_css_forward(y, coeffs, e, partial, steps, n,
# season, stream), sarima_css_backward(y, e, coeffs, grad, scale, steps, n,
# season, stream)
FORWARD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
FORECAST_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# sarima_forecast_plan(length, season, horizon, out): out = ForecastPlan
FORECAST_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
# the kernels' largest season: a segment of the fit's 16 chunks of 33 steps
# holds the carry rows of its lag (csrc/sarima.cu); the forecast takes the same
MAX_SEASON = 528
# the forecast's launch plan (csrc/sarima.cu:forecast_plan): the (length,
# season, horizon) of its compile-time form, a block's most threads, and the
# ring form's shared-memory budget (the H100's opt-in limit a block)
FIXED_SHAPE, FORECAST_THREADS, FORECAST_SMEM = (48, 12, 12), 128, 232_448


class ForecastPlan(NamedTuple):
    """The forecast's launch for one call: the compile-time form (1) or the
    ring form (0), threads a block, dynamic shared memory in bytes."""

    fixed: int
    threads: int
    smem: int


def forecast_plan(length: int, season: int, horizon: int) -> ForecastPlan:
    """The mirror of the C entry's plan: the compile-time form for
    ``FIXED_SHAPE``; else the ring form, with as many whole warps a block (at
    most FORECAST_THREADS) as their three rings of season + 1 floats fit in
    FORECAST_SMEM."""
    if (length, season, horizon) == FIXED_SHAPE:
        return ForecastPlan(1, FORECAST_THREADS, 0)
    per_thread = 3 * (season + 1) * 4
    threads = min(FORECAST_THREADS, FORECAST_SMEM // per_thread // 32 * 32)
    return ForecastPlan(0, threads, threads * per_thread)


def lagged(y: torch.Tensor, season: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-padded lag views y_{t-1}, y_{t-s}, y_{t-s-1}, aligned with y (time first)."""

    def lag(k: int) -> torch.Tensor:
        return torch.cat([y.new_zeros((min(k, y.shape[0]),) + y.shape[1:]), y[:-k]])

    return lag(1), lag(season), lag(season + 1)


def css_forward_reference(
    y: torch.Tensor, coeffs: torch.Tensor, season: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(e, partial): the innovations (T, N) and each node's sum of e_t^2 over
    t >= season + 1. Differentiable under autograd."""
    phi, sphi, theta, stheta = coeffs
    y1, ys, ys1 = lagged(y, season)
    ar = y - phi * y1 - sphi * ys + phi * sphi * ys1
    zero = torch.zeros_like(ar[0])
    e: list[torch.Tensor] = []
    for t in range(y.shape[0]):
        e1 = e[t - 1] if t >= 1 else zero
        es = e[t - season] if t >= season else zero
        es1 = e[t - season - 1] if t >= season + 1 else zero
        e.append(ar[t] - theta * e1 - stheta * es - theta * stheta * es1)
    eps = torch.stack(e)
    return eps, eps[season + 1 :].square().sum(0)


def css_backward_reference(
    y: torch.Tensor, e: torch.Tensor, coeffs: torch.Tensor, season: int, scale: float
) -> torch.Tensor:
    """(4, N): the gradient of scale/2 * sum_{t >= s+1} e_t^2 with respect to
    (phi, Phi, theta, Theta), by the adjoint g_t = scale e_t [t >= s+1]
    - theta g_{t+1} - Theta g_{t+s} - theta Theta g_{t+s+1} run backwards in t."""
    _, _, theta, stheta = coeffs
    steps = y.shape[0]
    zero = torch.zeros_like(y[0])
    g: list[torch.Tensor | None] = [None] * steps

    def later(t: int) -> torch.Tensor:
        return g[t] if t < steps else zero

    for t in reversed(range(steps)):
        own = scale * e[t] if t >= season + 1 else zero
        g[t] = own - theta * later(t + 1) - stheta * later(t + season) - theta * stheta * later(t + season + 1)
    return _coefficient_gradient(y, e, torch.stack(g), coeffs, season)


def _coefficient_gradient(
    y: torch.Tensor, e: torch.Tensor, adj: torch.Tensor, coeffs: torch.Tensor, season: int
) -> torch.Tensor:
    """(4, N): minus the sums over t of the adjoint g_t times d a_t / d c and
    d (e_t - a_t) / d c for c = (phi, Phi, theta, Theta)."""
    phi, sphi, theta, stheta = coeffs
    y1, ys, ys1 = lagged(y, season)
    e1, es, es1 = lagged(e, season)
    return -torch.stack([
        (adj * (y1 - sphi * ys1)).sum(0),
        (adj * (ys - phi * ys1)).sum(0),
        (adj * (e1 + stheta * es1)).sum(0),
        (adj * (es + theta * es1)).sum(0),
    ])


def chunked_lag_solve(b: torch.Tensor, coef: torch.Tensor, lag: int, chunk: int) -> torch.Tensor:
    """x_i = b_i - coef x_{i-lag} along the first axis, zero before 0, by the
    kernels' time-chunked decomposition: each chunk of ``chunk`` rows solved
    from a zero start; then, for each residue class of i mod lag, the carries
    across the chunks in order (the class's last row in a chunk gains
    (-coef)^cnt times the class's true value before the chunk, cnt its rows in
    the chunk); then every other row fixed up by (-coef)^m times the carry
    before its chunk, m its place in its class within the chunk. A chunk whose
    length is not a multiple of lag holds the classes at shifted offsets,
    which the carry rows (the lag rows before each chunk) absorb."""
    steps = b.shape[0]
    x = b.clone()
    starts = range(0, steps, chunk)
    for c0 in starts:
        for i in range(c0 + lag, min(c0 + chunk, steps)):
            x[i] = x[i] - coef * x[i - lag]
    base = -coef
    zero = torch.zeros_like(x[0])
    for rho in range(min(lag, steps)):
        carry = zero
        for c0 in starts:
            end = min(c0 + chunk, steps)
            first = c0 + (rho - c0) % lag
            if first >= end:
                continue  # a chunk shorter than lag may hold no row of this class
            last = first + (end - 1 - first) // lag * lag
            carry = x[last] + base ** ((last - first) // lag + 1) * carry
            x[last] = carry
    for c0 in starts:
        end = min(c0 + chunk, steps)
        for i in range(c0, end):
            if i + lag < end:  # not the last of its class in the chunk: the carries' row
                src = i - ((i - c0) // lag + 1) * lag
                x[i] = x[i] + base ** ((i - c0) // lag + 1) * (x[src] if src >= 0 else zero)
    return x


def css_forward_chunked_reference(
    y: torch.Tensor, coeffs: torch.Tensor, season: int, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``css_forward_reference`` through the forward kernel's decomposition:
    (1 + theta B)(1 + Theta B^s) e = a factored into w = a - theta w_{t-1},
    then e = w - Theta e_{t-s}, each solved in chunks of ``chunk`` steps
    (``chunked_lag_solve``). Nothing on the main path calls it: the CPU tests
    hold it against the sequential version."""
    phi, sphi, theta, stheta = coeffs
    y1, ys, ys1 = lagged(y, season)
    ar = y - phi * y1 - sphi * ys + phi * sphi * ys1
    eps = chunked_lag_solve(chunked_lag_solve(ar, theta, 1, chunk), stheta, season, chunk)
    return eps, eps[season + 1 :].square().sum(0)


def css_backward_chunked_reference(
    y: torch.Tensor, e: torch.Tensor, coeffs: torch.Tensor, season: int, scale: float, chunk: int
) -> torch.Tensor:
    """``css_backward_reference`` through the backward kernel's
    decomposition: (1 + theta F)(1 + Theta F^s) g = h with h_t = scale e_t
    [t >= s+1] is the forward's factored recursion in reversed time, solved
    in chunks of ``chunk`` reversed steps; then the four sums over g."""
    _, _, theta, stheta = coeffs
    h = scale * e
    h[: season + 1] = 0.0
    u = chunked_lag_solve(h.flip(0), theta, 1, chunk)
    adj = chunked_lag_solve(u, stheta, season, chunk).flip(0)
    return _coefficient_gradient(y, e, adj, coeffs, season)


def difference(x: torch.Tensor, season: int) -> torch.Tensor:
    """(T, ...) -> ((1-B)(1-B^s) x) of length T - season - 1."""
    d1 = x[1:] - x[:-1]
    return d1[season:] - d1[:-season]


def forecast_reference(x: torch.Tensor, coeffs: torch.Tensor, horizon: int, season: int) -> torch.Tensor:
    """x (B, L, N) raw windows -> (B, horizon, N): the recursion over each
    window's differenced history, then ``horizon`` steps with future
    innovations 0, inverting x_t = y_t + x_{t-1} + x_{t-s} - x_{t-s-1}."""
    b, length, n = x.shape
    xt = x.transpose(0, 1).reshape(length, b * n)
    c = coeffs[:, None, :].expand(4, b, n).reshape(4, b * n)
    phi, sphi, theta, stheta = c
    y = difference(xt, season)
    e, _ = css_forward_reference(y, c, season)
    ys, es, xs = list(y), list(e), list(xt)
    out = []
    for _ in range(horizon):
        y_next = (
            phi * ys[-1] + sphi * ys[-season] - phi * sphi * ys[-season - 1]
            + theta * es[-1] + stheta * es[-season] + theta * stheta * es[-season - 1]
        )
        x_next = y_next + xs[-1] + xs[-season] - xs[-season - 1]
        ys.append(y_next)
        es.append(torch.zeros_like(y_next))
        xs.append(x_next)
        out.append(x_next)
    return torch.stack(out).reshape(horizon, b, n).transpose(0, 1)


def forecast_ring_mirror(x: torch.Tensor, coeffs: torch.Tensor, horizon: int, season: int) -> torch.Tensor:
    """``forecast_reference`` in the forecast kernels' order: each window's
    rows taken once, in time order, into a ring of the last season + 1
    levels, y_t formed from it as x_u arrives (u = t + s + 1: x_{u-s} in the
    next slot, x_{u-s-1} in this one), y and e in rings of the same slots,
    then the steps ahead. Nothing on a card's path calls it: the CPU tests
    hold it against the plain version."""
    b, length, n = x.shape
    xt = x.transpose(0, 1).reshape(length, b * n)
    phi, sphi, theta, stheta = coeffs[:, None, :].expand(4, b, n).reshape(4, b * n)
    ps, ts = phi * sphi, theta * stheta
    size = season + 1
    zero = torch.zeros_like(xt[0])
    xr, yr, er = [zero] * size, [zero] * size, [zero] * size
    x1 = y1 = e1 = zero
    slot, out = 0, []
    for u in range(length + horizon):
        nxt = (slot + 1) % size
        if u < length:
            xu = xt[u]
            if u >= size:
                yt = (xu - x1) - (xr[nxt] - xr[slot])
                a = yt - phi * y1 - sphi * yr[nxt] + ps * yr[slot]
                et = a - theta * e1 - stheta * er[nxt] - ts * er[slot]
                yr[slot], er[slot], y1, e1 = yt, et, yt, et
        else:
            yt = phi * y1 + sphi * yr[nxt] - ps * yr[slot] + theta * e1 + stheta * er[nxt] + ts * er[slot]
            xu = yt + x1 + xr[nxt] - xr[slot]
            yr[slot], er[slot], y1, e1 = yt, zero, yt, zero
            out.append(xu)
        xr[slot], x1, slot = xu, xu, nxt
    return torch.stack(out).reshape(horizon, b, n).transpose(0, 1)


def _check(name: str, *tensors: torch.Tensor, season: int = 1) -> None:
    if season > MAX_SEASON:
        raise ValueError(f"{name} takes seasons up to {MAX_SEASON}, got {season}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors, got {t.dtype} (contiguous {t.is_contiguous()})")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: the tensors lie on different devices")


def css_forward(y: torch.Tensor, coeffs: torch.Tensor, season: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(e, partial) of ``css_forward_reference``: the plain version on the
    CPU, the kernel on the card."""
    steps, n = y.shape
    if tuple(coeffs.shape) != (4, n) or season < 1:
        raise ValueError(f"coeffs {tuple(coeffs.shape)} must be (4, {n}) and season >= 1, got {season}")
    if y.device.type == "cpu":
        return css_forward_reference(y, coeffs, season)
    _build.refuse_grad(FORWARD, "fit through css_loss_and_grad", y, coeffs)
    _check(FORWARD, y, coeffs, season=season)
    e = torch.empty_like(y)
    partial = torch.empty(n, dtype=torch.float32, device=y.device)
    fn = _build.function("sarima_css_forward", FORWARD_ARGTYPES)
    err = fn(y.data_ptr(), coeffs.data_ptr(), e.data_ptr(), partial.data_ptr(), steps, n, season,
             _build.stream_handle(y.device))
    _build.check(FORWARD, err)
    _build.count_launch(FORWARD)
    return e, partial


def css_backward(
    y: torch.Tensor, e: torch.Tensor, coeffs: torch.Tensor, season: int, scale: float
) -> torch.Tensor:
    """(4, N) of ``css_backward_reference``: the plain version on the CPU,
    the kernel on the card."""
    steps, n = y.shape
    if tuple(e.shape) != (steps, n) or tuple(coeffs.shape) != (4, n):
        raise ValueError(f"e {tuple(e.shape)} and coeffs {tuple(coeffs.shape)} do not fit y {(steps, n)}")
    if y.device.type == "cpu":
        return css_backward_reference(y, e, coeffs, season, scale)
    _build.refuse_grad(BACKWARD, "fit through css_loss_and_grad", y, e, coeffs)
    _check(BACKWARD, y, e, coeffs, season=season)
    grad = torch.empty((4, n), dtype=torch.float32, device=y.device)
    fn = _build.function("sarima_css_backward", BACKWARD_ARGTYPES)
    err = fn(y.data_ptr(), e.data_ptr(), coeffs.data_ptr(), grad.data_ptr(), float(scale), steps, n, season,
             _build.stream_handle(y.device))
    _build.check(BACKWARD, err)
    _build.count_launch(BACKWARD)
    return grad


def _loss_and_grad(raw, y, season, forward, backward) -> tuple[torch.Tensor, torch.Tensor]:
    tanh = torch.tanh(raw)
    coeffs = (0.99 * tanh).contiguous()
    count = (y.shape[0] - season - 1) * y.shape[1]
    e, partial = forward(y, coeffs, season)
    grad = backward(y, e, coeffs, season, 2.0 / count)
    return partial.sum() / count, grad * (0.99 * (1.0 - tanh * tanh))


def css_loss_and_grad(raw: torch.Tensor, y: torch.Tensor, season: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d raw) of the CSS objective: the mean of e_t^2 over
    t >= season + 1 and every node, with coefficients 0.99 tanh(raw)."""
    return _loss_and_grad(raw, y, season, css_forward, css_backward)


def css_loss_and_grad_reference(raw: torch.Tensor, y: torch.Tensor, season: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``css_loss_and_grad`` through the plain versions on any device."""
    return _loss_and_grad(raw, y, season, css_forward_reference, css_backward_reference)


def css_loss_and_grad_chunked_reference(
    raw: torch.Tensor, y: torch.Tensor, season: int, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``css_loss_and_grad`` through the chunked mirrors of the kernels."""

    def forward(y, coeffs, season):
        return css_forward_chunked_reference(y, coeffs, season, chunk)

    def backward(y, e, coeffs, season, scale):
        return css_backward_chunked_reference(y, e, coeffs, season, scale, chunk)

    return _loss_and_grad(raw, y, season, forward, backward)


def forecast(x: torch.Tensor, coeffs: torch.Tensor, horizon: int, season: int) -> torch.Tensor:
    """(B, horizon, N) of ``forecast_reference``: the plain version on the
    CPU (any season), the kernel on the card (seasons up to MAX_SEASON)."""
    b, length, n = x.shape
    if tuple(coeffs.shape) != (4, n):
        raise ValueError(f"coeffs {tuple(coeffs.shape)} must be (4, {n})")
    if length < 2 * (season + 1) or horizon < 1:
        raise ValueError(f"windows of {length} steps and horizon {horizon} do not fit season {season}")
    if x.device.type == "cpu":
        return forecast_reference(x, coeffs, horizon, season)
    _build.refuse_grad(FORECAST, "the forecast is not differentiable on the card", x, coeffs)
    _check(FORECAST, x, coeffs, season=season)
    out = torch.empty((b, horizon, n), dtype=torch.float32, device=x.device)
    fn = _build.function("sarima_forecast", FORECAST_ARGTYPES)
    err = fn(x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), b, length, n, season, horizon,
             _build.stream_handle(x.device))
    _build.check(FORECAST, err)
    _build.count_launch(FORECAST)
    return out
