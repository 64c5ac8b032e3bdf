"""The stencil GAT's CUDA kernel (csrc/gat_stencil.cu) on the card, against
its plain version (ops/gat_stencil.py:gat_stencil_reference), at card_cases.py's
GAT_CASES (the tiled form) and GAT_GENERAL_CASES (the general form), in fp32
and bf16: within the port's kernel tolerance, padded lanes exactly 0, each
call launching its own form once; the general form also gives the same bits
twice and plans as the Python mirror (ops/gat_stencil.py:general_plan) does.

On the card: ``python -m pytest tests/test_torch_gat_stencil_card.py -m cuda
--noconftest``; every case skips without one."""

import ctypes
import functools

import pytest
import torch

from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
from tec_mollm_tpu_torch.ops import _build
from tec_mollm_tpu_torch.ops import gat_stencil as g
import card_cases as cases
from card_cases import launched
from torch_card import DTYPES, assert_close, card  # noqa: F401 (card: a fixture)

pytestmark = pytest.mark.cuda


@functools.cache
def _graph():
    return build_graph(*grid_coordinates(41, 71), distance_threshold_km=150.0)


def _c_plan(shifts, channels: int, n: int, bf16: bool) -> g.GeneralPlan:
    """The general form's plan for a call, from the C entry gat_stencil_general_plan."""
    out = (ctypes.c_longlong * len(g.GeneralPlan._fields))()
    host = g._shift_array(tuple(shifts))
    fn = _build.function("gat_stencil_general_plan", g.PLAN_ARGTYPES)
    _build.check("gat_stencil_general_plan", fn(ctypes.cast(host, ctypes.c_void_p), len(shifts), channels, n,
                                                 int(bf16), ctypes.cast(out, ctypes.c_void_p)))
    return g.GeneralPlan(*out)


def _check(got, xl, xr, valid, valid_plain, att, shifts, dtype: str) -> None:
    """Within the tolerance of the plain version, the lanes past the last
    real node exactly 0."""
    assert_close(got, ops.gat_stencil_reference(xl, xr, valid_plain, att, shifts), dtype)
    real = int(valid.any(dim=0).nonzero().max()) + 1
    assert bool((got[..., real:] == 0).all()), "padded lanes not exactly 0"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("label", list(cases.GAT_CASES))
def test_tiled_form_matches_the_plain_version(card, label, dtype):
    cfg = Config().resolved().model
    case = (*cases.GAT_CASES[label], cfg.spatial_heads, cfg.spatial_out_channels)
    xl, xr, valid, valid_plain, att, shifts = cases.gat_inputs(_graph(), case, DTYPES[dtype], card, seed=1)
    ops.reset_counts()
    got = ops.gat_stencil_attention(xl, xr, valid, att, shifts)
    assert launched(ops.launch_counts(), *cases.GAT) == {"gat_stencil": 1, "gat_stencil_general": 0}
    _check(got, xl, xr, valid, valid_plain, att, shifts, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("label", list(cases.GAT_GENERAL_CASES))
def test_general_form_matches_the_plain_version_twice_over(card, label, dtype):
    """The case "forced" runs the general form through the bare C entry at
    the tiled form's own shape (not counted); every other case goes through
    the wrapper.
    The plan of "overflow" reads some offsets from device memory, and "oob"'s
    shifts past N reach no node."""
    case = cases.GAT_GENERAL_CASES[label]
    _, _, n, _, channels = case
    xl, xr, valid, valid_plain, att, shifts = cases.gat_inputs(_graph(), case, DTYPES[dtype], card, seed=2)
    if label == "forced":
        def call():
            return cases.gat_bare_entry(xl, xr, valid, att, shifts, general=True)().clone()
        want_launches = {"gat_stencil": 0, "gat_stencil_general": 0}
    else:
        def call():
            return ops.gat_stencil_attention(xl, xr, valid, att, shifts)
        want_launches = {"gat_stencil": 0, "gat_stencil_general": 1}
    ops.reset_counts()
    got = call()
    assert launched(ops.launch_counts(), *cases.GAT) == want_launches
    _check(got, xl, xr, valid, valid_plain, att, shifts, dtype)
    assert torch.equal(got, call()), "two launches differ"
    plan = _c_plan(shifts, channels, n, dtype == "bf16")
    assert plan == g.general_plan(shifts, channels, n, 2 if dtype == "bf16" else 4)
    if dtype == "bf16" and label == "overflow":
        assert 0 < plan.window_offsets < plan.reach, plan
    if dtype == "bf16" and label == "oob":
        assert plan.reach == len(_graph().stencil_shifts), plan
