"""The stencil GAT's general form on the CPU: the layouts and stencils that the
tiled CUDA kernel does not take (ops/gat_stencil.py:tiled_takes).

The Pallas body (in interpret mode, as tests/test_ops.py runs it) against the
port's plain version at each general layout, in fp32 and bf16; the plain
mirror of the general CUDA kernel's decomposition (gat_stencil_general_mirror:
node tiles and their windows, the k1/k2 split of leaky-ReLU in log2 units, the
lazily rescaled online softmax, reads outside the window) against the plain
version, also where the span overflows the window and where shifts pass N;
and the kernel's plan (general_plan). tests/test_torch_gat_stencil_card.py
holds the kernel itself to the plain version on the card. fp32 tolerances
are the other GAT parity tests': the order of fp32 sums (about 1e-6
relative at these sizes); bf16 in and out may differ by one bf16 rounding of
the output (2^-8 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.ops.gat_stencil import gat_stencil_attention as jax_gat_stencil
from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.graph import grid_coordinates
from tec_mollm_tpu_torch.graph.builder import build_grid_stencil
from tec_mollm_tpu_torch.ops.gat_stencil import (
    GENERAL_BUDGET,
    gat_stencil_general_mirror,
    general_plan,
    tiled_takes,
)

TOL = {"fp32": dict(atol=2e-6, rtol=1e-5), "bf16": dict(atol=1e-2, rtol=1e-2)}
DTYPES = {"fp32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _in_range(shifts, n: int) -> np.ndarray:
    """(O, N): the neighbour n + shift lies inside [0, N)."""
    j = np.arange(n)[None, :] + np.asarray(shifts, np.int64)[:, None]
    return (j >= 0) & (j < n)


def _grid(rows: int, cols: int, km: float, pad: int = 0):
    shifts, valid = build_grid_stencil(*grid_coordinates(rows, cols), km)
    out = np.zeros((len(shifts), valid.shape[1] + pad), bool)
    out[:, :valid.shape[1]] = valid
    return tuple(int(s) for s in shifts), out


def _synthetic(n: int, offsets: int, reach: int, seed: int):
    """``offsets`` distinct shifts up to ``reach`` nodes (0 among them), each
    valid at random where its neighbour lies inside [0, N)."""
    rng = np.random.default_rng(seed)
    others = rng.choice(np.setdiff1d(np.arange(-reach, reach + 1), [0]), offsets - 1, replace=False)
    shifts = tuple(int(s) for s in np.sort(np.append(others, 0)))
    return shifts, (rng.random((offsets, n)) < 0.7) & _in_range(shifts, n)


# the general form's layouts: (heads, channels, stencil); 1 x 22 on the 6 x 8
# grid padded by 16 lanes, 4 x 16 on the unpadded 7 x 9 grid (63 nodes, rows
# of no whole 16-byte chunk), 2 x 11 with 70 offsets and shifts up to 200
# nodes on 400 (past the tiled form's 64 offsets and 144 nodes)
LAYOUTS = {
    "1x22": (1, 22, lambda: _grid(6, 8, 150.0, pad=16)),
    "4x16_n63": (4, 16, lambda: _grid(7, 9, 300.0)),
    "2x11_o70": (2, 11, lambda: _synthetic(400, 70, 200, seed=3)),
}


def _inputs(seed: int, m: int, heads: int, channels: int, n: int):
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(m, heads * channels, n)).astype(np.float32)
    xr = rng.normal(size=(m, heads * channels, n)).astype(np.float32)
    att = rng.normal(0, 0.5, size=(heads, channels)).astype(np.float32)
    return xl, xr, att


def _plain(xl, xr, valid, att, shifts, dtype):
    t = DTYPES[dtype][1]
    return ops.gat_stencil_reference(
        torch.from_numpy(xl).to(t), torch.from_numpy(xr).to(t), torch.from_numpy(valid),
        torch.from_numpy(att), shifts,
    )


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_take_the_general_form(layout):
    heads, channels, make = LAYOUTS[layout]
    shifts, _ = make()
    assert tiled_takes(shifts, heads, channels) is not None


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_pallas(layout, dtype):
    heads, channels, make = LAYOUTS[layout]
    shifts, valid = make()
    n = valid.shape[1]
    xl, xr, att = _inputs(0, 2, heads, channels, n)
    jt = DTYPES[dtype][0]
    want = np.asarray(jax_gat_stencil(
        jnp.asarray(xl, jt), jnp.asarray(xr, jt), jnp.asarray(valid), jnp.asarray(att), shifts, interpret=True,
    ), np.float32)
    got = _plain(xl, xr, valid, att, shifts, dtype)
    assert got.dtype == DTYPES[dtype][1]
    real = valid.any(axis=0)  # the Pallas body divides 0/0 on lanes with no valid offset; the port gives 0
    np.testing.assert_allclose(got.float().numpy()[..., real], want[..., real], **TOL[dtype])
    np.testing.assert_array_equal(got.float().numpy()[..., ~real], 0.0)


# the mirror's cases beyond the layouts: "overflow" shifts of 1,400 to 2,600
# nodes on 3,000, a span past the widest window a block holds; "oob" shifts of
# N and past it marked valid on every lane (the kernel counts their neighbours
# out of range; the plain version, which wraps around, gets the mask with the
# range check folded in); "wide" 1 x 40 channels (groups of 32); "o600" 600
# offsets, past the 512 whose bits a block keeps in shared memory
def _overflow():
    shifts, valid = _grid(6, 8, 150.0)
    n = 3000
    shifts = shifts + (1400, -1400, 2500, -2600)
    full = np.zeros((len(shifts), n), bool)
    full[:valid.shape[0], :valid.shape[1]] = valid
    full[valid.shape[0]:] = _in_range(shifts[valid.shape[0]:], n)
    return shifts, full


def _oob():
    shifts, valid = _grid(6, 8, 150.0, pad=16)
    n = valid.shape[1]
    extra = (n, -n - 3, 5000, -(2**31) + 1)
    return shifts + extra, np.concatenate([valid, np.ones((len(extra), n), bool)])


MIRROR_CASES = {
    **LAYOUTS,
    "overflow": (2, 11, _overflow),
    "oob": (1, 22, _oob),
    "wide": (1, 40, lambda: _grid(7, 9, 300.0)),
    "o600": (1, 7, lambda: _synthetic(700, 600, 699, seed=4)),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", MIRROR_CASES)
def test_mirror_matches_plain(case, dtype):
    heads, channels, make = MIRROR_CASES[case]
    shifts, valid = make()
    n = valid.shape[1]
    xl, xr, att = _inputs(1, 2, heads, channels, n)
    t = DTYPES[dtype][1]
    got = gat_stencil_general_mirror(
        torch.from_numpy(xl).to(t), torch.from_numpy(xr).to(t), torch.from_numpy(valid),
        torch.from_numpy(att), shifts,
    )
    want = _plain(xl, xr, valid & _in_range(shifts, n), att, shifts, dtype)
    assert got.dtype == t
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    real = valid.any(axis=0)
    assert not got[..., ~torch.from_numpy(real)].any()


def test_mirror_cases_reach_their_paths():
    """overflow reads offsets outside the window; oob's shifts past N reach no
    node; wide takes the wide form; o600 holds more offsets than a block
    keeps in shared memory."""
    def plan(case, itemsize=4):
        heads, channels, make = MIRROR_CASES[case]
        shifts, valid = make()
        return general_plan(shifts, channels, valid.shape[1], itemsize), len(shifts)

    for itemsize in (2, 4):
        p, _ = plan("overflow", itemsize)
        assert 0 < p.window_offsets < p.reach == 9 and p.wlen > 0
    p, o = plan("oob")
    assert p.reach == p.window_offsets == o - 4
    assert plan("wide")[0].q == 0
    p, o = plan("o600")
    assert p.res_offsets == 512 < o


# the flagship grid's stencils at the widths the general form serves
FLAGSHIP = {km: build_grid_stencil(*grid_coordinates(41, 71), km)[0] for km in (150.0, 450.0)}


@pytest.mark.parametrize("km, channels, itemsize, want", [
    (150.0, 22, 2, dict(q=6, tile=256, wlen=400, lo=-72, rec=28)),  # the 1 x 22 serve batch
    (150.0, 16, 2, dict(q=5, tile=256, wlen=400, lo=-72, rec=20)),  # 4 x 16
    (150.0, 11, 4, dict(q=3, tile=256, wlen=400, lo=-72, rec=12)),  # 2 x 11 in fp32
    (450.0, 11, 2, dict(q=3, tile=256, wlen=832, lo=-288, rec=12)),  # the 450 km stencil
    (450.0, 40, 4, dict(q=0, tile=64)),  # a wide head whose window overflows
])
def test_plan_at_the_flagship(km, channels, itemsize, want):
    shifts = [int(s) for s in FLAGSHIP[km]]
    p = general_plan(shifts, channels, 2944, itemsize)
    assert {k: getattr(p, k) for k in want} == want
    assert p.bytes <= GENERAL_BUDGET and p.reach == len(shifts)
    assert (p.window_offsets == p.reach) == (channels != 40)


@pytest.mark.parametrize("seed", range(6))
def test_plan_invariants(seed):
    """Random stencils and widths: the layout fits the budget, the window is
    whole 16-byte chunks at a chunk boundary, the tile is one the kernel
    takes, and a window that holds every reaching offset is the full span."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.choice([37, 100, 2911, 2944, 100_000]))
        channels = int(rng.choice([1, 7, 11, 16, 22, 31, 32, 64, 500, 3000]))
        spread = int(rng.choice([3, 300, 3000, 2**31 - 1]))
        shifts = [int(s) for s in rng.integers(-spread, spread, size=int(rng.integers(1, 700)))]
        itemsize = int(rng.choice([2, 4]))
        p = general_plan(shifts, channels, n, itemsize)
        e = 16 // itemsize
        reach = [s for s in shifts if -n < s < n]
        assert p.bytes <= GENERAL_BUDGET and p.tile in (256, 128, 64)
        assert p.wlen % e == 0 and p.lo % e == 0 and p.reach == len(reach)
        assert p.rec % 4 == 0 and (p.rec // 4) % 2 == 1 and p.rec > (4 * p.q - 1 if p.q else channels)
        if reach and p.window_offsets == p.reach and p.wlen:
            assert p.lo <= min(reach) and max(reach) - p.lo <= p.wlen - p.tile


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wrapper_on_cpu_is_the_plain_version(layout):
    heads, channels, make = LAYOUTS[layout]
    shifts, valid = make()
    xl, xr, att = (torch.from_numpy(a) for a in _inputs(2, 2, heads, channels, valid.shape[1]))
    v = torch.from_numpy(valid)
    torch.testing.assert_close(
        ops.gat_stencil_attention(xl, xr, v, att, shifts),
        ops.gat_stencil_reference(xl, xr, v, att, shifts), rtol=0, atol=0,
    )
