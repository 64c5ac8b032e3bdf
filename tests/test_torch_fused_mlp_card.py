"""The fused LayerNorm -> MLP -> residual CUDA kernel (csrc/fused_mlp.cu) on the
card, against its plain version (ops/fused_mlp.py:fused_ln_mlp_reference), in
bf16 at card_cases.py's MLP_ROWS, one launch a call; and at the serve batch
with x scaled by 2^-6, where the output is about the MLP branch alone.

On the card: ``python -m pytest tests/test_torch_fused_mlp_card.py -m cuda
--noconftest``; every case skips without one."""

import pytest

from tec_mollm_tpu_torch import ops
import card_cases as cases
from card_cases import launched
from torch_card import assert_close, card  # noqa: F401 (card: a fixture)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("label", list(cases.MLP_ROWS))
def test_kernel_matches_the_plain_version(card, label):
    x, *weights = cases.mlp_inputs(cases.MLP_ROWS[label], card, seed=6)
    ops.reset_counts()
    got = ops.fused_ln_mlp(x, *weights)
    assert launched(ops.launch_counts(), "fused_mlp") == {"fused_mlp": 1}
    assert_close(got, ops.fused_ln_mlp_reference(x, *weights), "bf16")


def test_branch_alone_matches_the_plain_version(card):
    """The residual (|x| ~ 1) dominates the output, so the check above barely
    sees an error in the MLP branch (~0.35). Scaled by 2^-6 (exact in bf16), x
    keeps its LN output and the same branch, and the output is about the
    branch alone: the same tolerance then bounds the GEMMs and their
    epilogues."""
    x, *weights = cases.mlp_inputs(cases.MLP_ROWS["path"], card, seed=6)
    x = x * 2.0**-6
    assert_close(ops.fused_ln_mlp(x, *weights), ops.fused_ln_mlp_reference(x, *weights), "bf16")
