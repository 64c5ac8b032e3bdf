"""The port's CUDA kernels at the shapes they are checked and timed at: the
case tables, the input builders and the bare C entries that the kernels'
``cuda`` test cases (tests/test_torch_*_card.py, the ``cuda`` cases of
tests/test_torch_temporal_kernel.py and tests/test_torch_sarima.py) and
chip_smoke.py's kernel table share, and the tolerance a kernel is held to
against its plain version. It imports no JAX, and torch only inside its
functions."""

from __future__ import annotations

import importlib

import numpy as np

# a kernel against its plain version: |kernel - plain| <= ATOL + RTOL * |plain|,
# (ATOL, RTOL) by the output's dtype. Both compute in fp32 and round the output
# to the tensor's dtype; they differ in the order of fp32 sums (and, in the
# fused MLP, in the bf16 rounding of the hidden activations), so a bf16 output
# may differ by one bf16 ulp (2^-8 relative).
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-5, 1e-5)}
# the SARIMA kernels against theirs: each output's largest difference over its
# largest magnitude (fp32 both; the kernel contracts multiply-adds and sums a
# node's terms in time order, the plain version sums with torch's reductions,
# and the recursion is stable with |coefficients| < 0.99, so the two differ at
# fp32 rounding)
SARIMA_RTOL = 1e-4
# attention dropout of the training path (ModelConfig.llm_dropout) and the seed
# of the kernels' dropout
DROPOUT, DROPOUT_SEED = 0.1, 12345
# the flagship eval batch (the service's max_batch, and the kernels' batch)
BATCH = 8
# the flagship's node axis as the model pads it (2911 nodes to a multiple of 128)
PADDED_NODES = 2944
# launch-count names of the stencil GAT kernel's two forms
GAT = ("gat_stencil", "gat_stencil_general")
# flash attention cases: (batch, T, causal, head dim, dtypes) by label; "path"
# is the byte LM's pretraining batch (64 rows of seq_len 128 + 1 tokens, 12 heads
# of 64); "t300" makes the JAX wrapper pad T to 512 and mask keys >= t_valid;
# "t1024" is the shape of scripts/bench_flash_attention.py; "d32" and "d128" the
# kernel's other head dims
FLASH_CASES = {
    "path": (64, 129, True, 64, ("fp32", "bf16")),
    "t300": (8, 300, False, 64, ("fp32", "bf16")),
    "t1024": (8, 1024, True, 64, ("fp32", "bf16")),
    "d32": (64, 129, True, 32, ("bf16",)),
    "d128": (64, 129, True, 128, ("bf16",)),
}
FLASH_HEADS = 12
# stencil GAT cases of the tiled kernel: (slices M, stencil, nodes N) by label,
# the stencil a radius in km on the 41x71 grid or "small", the 150 km stencil
# of the GAT_SMALL_GRID grid; "path" is the flagship serve batch (8 windows x
# 48 steps, N padded to 2944), "eval" the eval step's batch of 16 windows,
# "trainer" the trainer's validation batch (batch_size 2 x L_in 48 of
# Config()), "r300" the 300 km (long_horizon) stencil (33 offsets, largest
# |shift| 144), "n2911" the unpadded node axis (rows not 16-byte aligned),
# "m70000" more slices than a grid's y axis held (65535), padded to 64 nodes
GAT_CASES = {
    "path": (BATCH * 48, 150.0, PADDED_NODES),
    "eval": (2 * BATCH * 48, 150.0, PADDED_NODES),
    "trainer": (2 * 48, 150.0, PADDED_NODES),
    "r300": (2 * BATCH * 48, 300.0, PADDED_NODES),
    "n2911": (BATCH * 48, 150.0, 2911),
    "m70000": (70_000, "small", 64),
}
# and of its general form: (slices M, stencil, nodes N, heads, channels), the
# stencil as above or a synthetic one by name (GAT_SYNTHETIC); "path" is the
# serve batch of a 1 head x 22 channel config (trainer phase), "r450" the
# 450 km stencil (81 offsets, largest |shift| 284) at the trainer's validation
# batch, "n2911" 4 heads x 16 channels on the unpadded node axis; "forced" the
# flagship 2 x 11 eval batch through the bare C entry with general = 1 (the
# tiled form's own shape, timed beside the tiled form's bare entry: the
# general form's yardstick); "overflow" a span past the widest window that
# fits (the offsets outside it read from device memory); "oob" shifts past N
# marked valid, whose neighbours the kernel must count out of range
GAT_GENERAL_CASES = {
    "path": (BATCH * 48, 150.0, PADDED_NODES, 1, 22),
    "r450": (2 * 48, 450.0, PADDED_NODES, 2, 11),
    "n2911": (2 * 48, 150.0, 2911, 4, 16),
    "forced": (BATCH * 48, 150.0, PADDED_NODES, 2, 11),
    "overflow": (2 * 48, "overflow", PADDED_NODES, 2, 11),
    "oob": (2 * 48, "oob", PADDED_NODES, 1, 22),
}
# the synthetic stencils: shifts added to the 150 km stencil's, each valid on
# every real lane whose neighbour is in range ("overflow": a span of 5,100
# nodes, about three times the widest window a block holds in bf16) or on
# every real lane ("oob": N, -N - 3 and 5,000 nodes, no neighbour in range; the
# plain version, which wraps around, is given the mask with the range check
# folded in)
GAT_SYNTHETIC = {"overflow": lambda n: (1400, -1400, 2500, -2600), "oob": lambda n: (n, -n - 3, 5000)}
GAT_SMALL_GRID = (6, 8)
# fused MLP cases: rows by label; "path" is the serve batch (8 windows x 2944
# padded nodes x 3 patches), "window" one window's rows, "ragged" a row count
# that no tile divides
MLP_ROWS = {"path": BATCH * PADDED_NODES * 3, "window": PADDED_NODES * 3, "ragged": 1000}
# the SARIMA kernels' series: its steps (the eval harness's fit_window), the
# season and the forecast batch (the harness's); AR-dominated (the JAX
# package's recovery case)
SARIMA_T, SARIMA_SEASON, SARIMA_BATCH = 2000, 12, 64
SARIMA_TRUTH = (0.6, 0.0, 0.0, 0.0)
# the forecast's windows in a batch large enough that no call's host cost
# hides its device time (a year's test split is 4,380 windows)
SARIMA_FORECAST_LARGE = 1024


def launched(counts: dict, *names: str) -> dict:
    """The launch counts of the kernels ``names`` (0 where one did not launch):
    a check that compares these holds only the kernels it names."""
    return {name: counts.get(name, 0) for name in names}


# --- the kernels' inputs ---

def gat_inputs(graph, case: tuple, dtype, device, seed: int) -> tuple:
    """(xl, xr, valid, valid_plain, att, shifts) of a stencil GAT case (M,
    stencil, N, heads, channels) as GAT_CASES and GAT_GENERAL_CASES give it,
    ``graph`` the 41x71 grid's at 150 km; lanes past the grid's nodes are
    padding. valid_plain is the mask the plain version takes: it wraps
    around, so the range check is folded in."""
    import torch

    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.graph.builder import build_grid_stencil

    m, km, n, heads, channels = case
    if km == "small":
        small = build_graph(*grid_coordinates(*GAT_SMALL_GRID))
        shifts, v = small.stencil_shifts, small.stencil_valid
    elif km == 150.0 or km in GAT_SYNTHETIC:
        shifts, v = graph.stencil_shifts, graph.stencil_valid
    else:
        shifts, v = build_grid_stencil(*grid_coordinates(41, 71), km)
    shifts = [int(s) for s in shifts]
    real = v.shape[1]
    valid = torch.zeros(len(shifts), n, dtype=torch.bool, device=device)
    valid[:, :real] = torch.as_tensor(v, device=device)
    if km in GAT_SYNTHETIC:
        nodes = torch.arange(n, device=device)
        extra = list(GAT_SYNTHETIC[km](n))
        rows = []
        for s in extra:
            row = nodes < real
            if km == "overflow":
                row &= (nodes + s >= 0) & (nodes + s < n)
            rows.append(row)
        shifts += extra
        valid = torch.cat([valid, torch.stack(rows)])
    j = torch.arange(n, device=device)[None, :] + torch.tensor(shifts, device=device)[:, None]
    gen = torch.Generator(device=device).manual_seed(seed)
    att = torch.randn(heads, channels, generator=gen, device=device) * 0.3
    xl, xr = (torch.randn(m, heads * channels, n, generator=gen, device=device).to(dtype) for _ in range(2))
    return xl, xr, valid, valid & (j >= 0) & (j < n), att, tuple(shifts)


def attention_inputs(device, seed: int) -> tuple:
    """(q, k, v, g) of the short causal attention at the flagship serve batch
    (8 windows x 2944 padded nodes, 3 patches, 768 wide), bf16: q, k, v views
    of one c_attn output, as the model hands them over, and an upstream
    gradient of their shape."""
    import torch

    from tec_mollm_tpu_torch.config import Config

    cfg = Config().resolved().model
    rows, t, d = BATCH * PADDED_NODES, cfg.num_patches, cfg.d_llm
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(rows, t, 3 * d, generator=gen, device=device).bfloat16()
    g = torch.randn(rows, t, d, generator=gen, device=device).bfloat16()
    return (*qkv.split(d, dim=-1), g)


def mlp_inputs(rows: int, device, seed: int) -> tuple:
    """(x, ln_w, ln_b, w1, b1, w2, b2) of the fused LN -> MLP -> residual at
    ``rows`` rows of the flagship width: x and the matrices bf16, the
    LayerNorm's affine and the biases fp32."""
    import torch

    from tec_mollm_tpu_torch.config import Config

    cfg = Config().resolved().model
    d = cfg.d_llm
    dh = cfg.llm_mlp_ratio * d
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    f32 = torch.float32
    return (rand(rows, d), 1.0 + rand(d, std=0.1, dtype=f32), rand(d, std=0.1, dtype=f32), rand(d, dh, std=0.02),
            rand(dh, std=0.02, dtype=f32), rand(dh, d, std=0.02), rand(d, std=0.02, dtype=f32))


def flash_views(b: int, t: int, hd: int, dtype, device, seed: int, pad: int = 0) -> tuple:
    """q, k, v (B, T, FLASH_HEADS, hd) views of one (B, T, 3 x FLASH_HEADS x hd)
    c_attn output, as the model hands them over; ``pad`` leading elements a
    row shift every view (1: not 16-byte aligned)."""
    import torch

    d = FLASH_HEADS * hd
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * d + pad, generator=gen, device=device).to(dtype)[..., pad:]
    return tuple(a.reshape(b, t, FLASH_HEADS, hd) for a in qkv.split(d, dim=-1))


def simulate_sarima(steps: int, nodes: int, season: int, coeffs: tuple, seed: int) -> np.ndarray:
    """(steps, nodes) drawn from SARIMA(1,1,1)x(1,1,1,season) with the given
    (phi, Phi, theta, Theta): the SARMA recursion on unit innovations, then
    (1-B) and (1-B^s) integrated (the JAX test's simulator, over all nodes)."""
    phi, sphi, theta, stheta = coeffs
    eps = np.random.default_rng(seed).normal(0, 1, (steps, nodes))
    y = np.zeros((steps, nodes))
    for t in range(steps):
        y[t] = eps[t]
        if t >= 1:
            y[t] += phi * y[t - 1] + theta * eps[t - 1]
        if t >= season:
            y[t] += sphi * y[t - season] + stheta * eps[t - season]
        if t >= season + 1:
            y[t] += -phi * sphi * y[t - season - 1] + theta * stheta * eps[t - season - 1]
    x1 = np.cumsum(y, axis=0)
    x = np.zeros_like(x1)
    for t in range(steps):
        x[t] = x1[t] + (x[t - season] if t >= season else 0.0)
    return x


def sarima_windows(series: np.ndarray, count: int, length: int, device):
    """``count`` windows of ``length`` steps spread evenly over ``series``: (count, length, N) fp32."""
    import torch

    starts = np.linspace(0, series.shape[0] - length, count).astype(np.int64)
    return torch.tensor(np.stack([series[a : a + length] for a in starts]), dtype=torch.float32, device=device)


def sarima_inputs(seed: int, device) -> dict:
    """The SARIMA kernels' flagship inputs: a seeded simulated AR-dominated
    series of (SARIMA_T, 2911) (simulate_sarima at SARIMA_TRUTH), its scaled
    difference y at SARIMA_SEASON (what the fit's recursion reads), seeded raw
    parameters and their coefficients (|c| < 0.99), the adjoint's loss scale,
    and SARIMA_BATCH windows of L_in steps for the forecast of L_out."""
    import torch

    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models import sarima

    cfg = Config().resolved()
    n, s = cfg.model.num_nodes, SARIMA_SEASON
    series = simulate_sarima(SARIMA_T, n, s, SARIMA_TRUTH, seed)
    y = sarima.scaled_difference(series, s, device)
    raw = torch.randn(4, n, generator=torch.Generator(device=device).manual_seed(seed), device=device) * 0.5
    return {"series": series, "y": y, "raw": raw, "coeffs": (0.99 * torch.tanh(raw)).contiguous(),
            "scale": 2.0 / ((y.shape[0] - s - 1) * n), "season": s, "L_in": cfg.train.L_in,
            "horizon": cfg.train.L_out, "wins": sarima_windows(series, SARIMA_BATCH, cfg.train.L_in, device)}


# --- bare C entries: a wrapper's launch without its checks and Python ---

def gat_bare_entry(xl, xr, valid, att, shifts, general: bool = False):
    """A call of the GAT kernel's C entry with its arguments marshalled once,
    into a fresh output: the wrapper's launch without its checks and Python
    (the timing cap); with ``general`` the general form whatever the layout.
    Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import gat_stencil as g

    att32 = att.float().contiguous()
    out = torch.empty_like(xl)
    fn = _build.function("gat_stencil_forward", g.ARGTYPES)
    shifts = g.check_stencil(shifts)
    args = list(g.entry_args(xl, xr, valid, att32, shifts, out, 0.2))
    if general:
        args[4], args[14] = g._device_shifts(shifts, xl.device).data_ptr(), 1

    def call():
        _build.check(g.NAME, fn(*args))
        return out

    return call


def flash_bare_entry(q, k, v, causal: bool):
    """A call of the flash kernel's C entry with its arguments marshalled
    once (``flash_attention.entry_args``), into a fresh output: the wrapper's
    launch without its checks and Python. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build

    # the module (ops re-exports its function under the same name)
    fa = importlib.import_module("tec_mollm_tpu_torch.ops.flash_attention")
    q, k, v = (fa._aligned16(a) for a in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.function("flash_attention_forward", fa.ARGTYPES)
    args = fa.entry_args(q, k, v, out, causal, 0.0, 0)

    def call():
        _build.check(fa.NAME, fn(*args))
        return out

    return call


def sarima_bare_entry(y, coeffs, season: int, e=None, scale: float = 0.0):
    """A call of a SARIMA fit kernel's C entry (the forward, or with ``e``
    the adjoint) with its arguments marshalled once, into fresh outputs: the
    wrapper's launch without its checks and Python. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import sarima as sops

    steps, n = y.shape
    stream = _build.stream_handle(y.device)
    if e is None:
        name, out = sops.FORWARD, (torch.empty_like(y), torch.empty(n, dtype=torch.float32, device=y.device))
        fn = _build.function("sarima_css_forward", sops.FORWARD_ARGTYPES)
        args = (y.data_ptr(), coeffs.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), steps, n, season, stream)
    else:
        name, out = sops.BACKWARD, torch.empty((4, n), dtype=torch.float32, device=y.device)
        fn = _build.function("sarima_css_backward", sops.BACKWARD_ARGTYPES)
        args = (y.data_ptr(), e.data_ptr(), coeffs.data_ptr(), out.data_ptr(), scale, steps, n, season, stream)

    def call():
        _build.check(name, fn(*args))
        return out

    return call


def forecast_bare_entry(x, coeffs, horizon: int, season: int):
    """A call of the SARIMA forecast kernel's C entry with its arguments
    marshalled once, into a fresh output: the wrapper's launch without its
    checks and Python. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build
    from tec_mollm_tpu_torch.ops import sarima as sops

    b, length, n = x.shape
    out = torch.empty((b, horizon, n), dtype=torch.float32, device=x.device)
    fn = _build.function("sarima_forecast", sops.FORECAST_ARGTYPES)
    args = (x.data_ptr(), coeffs.data_ptr(), out.data_ptr(), b, length, n, season, horizon,
            _build.stream_handle(x.device))

    def call():
        _build.check(sops.FORECAST, fn(*args))
        return out

    return call


def temporal_bare_entry(x, wpack, params):
    """A call of the temporal kernel's C entry with its arguments marshalled
    once, into a fresh output: the wrapper's launch without its checks and
    Python. x is a (B, N, 48, C) view with unit channel stride. Not counted."""
    import torch

    from tec_mollm_tpu_torch.ops import _build

    tc = importlib.import_module("tec_mollm_tpu_torch.ops.temporal_conv")  # ops.temporal_conv is the function
    b, n = x.shape[:2]
    out = torch.empty(b * n, tc.OUT_LENGTH, tc.CHANNELS[-1], dtype=x.dtype, device=x.device)
    fn = _build.function("temporal_conv_forward", tc.ARGTYPES)
    args = (x.data_ptr(), b * n, n, x.stride(0), x.stride(1), x.stride(2), x.shape[-1], wpack.data_ptr(),
            wpack.numel() * wpack.element_size(), params.data_ptr(), out.data_ptr(), _build.stream_handle(x.device))

    def call():
        _build.check(tc.NAME, fn(*args))
        return out

    return call
