"""The short causal attention's CUDA kernels (csrc/short_attention.cu) on the
card, against their plain versions (ops/short_attention.py), at the flagship
serve batch (card_cases.attention_inputs: q, k, v views of one c_attn
output): the forward in bf16 at dropout p = 0 and at the training call's p =
0.1, the backward in fp32 and bf16 at both, one launch a call; and the
forward's own keep mask, read back through its output, equal to the plain
hash's bit for bit, keeping 1 - p of the draws and changing with the seed.

On the card: ``python -m pytest tests/test_torch_short_attention_card.py -m
cuda --noconftest``; every case skips without one."""

import pytest
import torch

from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.config import Config
from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_threshold
import card_cases as cases
from card_cases import launched
from torch_card import KEPT_TOL, assert_close, card  # noqa: F401 (card: a fixture)

pytestmark = pytest.mark.cuda

HEADS = Config().resolved().model.llm_heads
P, SEED = cases.DROPOUT, cases.DROPOUT_SEED


@pytest.mark.parametrize("rate", [0.0, P])
def test_forward_matches_the_plain_version(card, rate):
    q, k, v, _ = cases.attention_inputs(card, seed=3)
    ops.reset_counts()
    got = ops.short_attention_forward(q, k, v, HEADS, rate, SEED)
    assert launched(ops.launch_counts(), "short_attention") == {"short_attention": 1}
    assert_close(got, ops.short_causal_attention_reference(q, k, v, HEADS, rate, SEED), "bf16")


@pytest.mark.parametrize("rate", [0.0, P])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_backward_matches_the_plain_version(card, dtype, rate):
    """q, k, v, g -> [dq | dk | dv] (B*N, T, 3D); in fp32 on fp32 views of
    the same c_attn output."""
    q, k, v, g = cases.attention_inputs(card, seed=4)
    if dtype == "fp32":
        q, k, v = torch.cat([q, k, v], dim=-1).float().split(q.shape[-1], dim=-1)
        g = g.float()
    ops.reset_counts()
    got = ops.short_attention_backward(q, k, v, g, HEADS, rate, SEED)
    assert launched(ops.launch_counts(), "short_attention_bwd") == {"short_attention_bwd": 1}
    assert_close(got, ops.short_causal_attention_backward_reference(q, k, v, g, HEADS, rate, SEED), dtype)


def test_dropout_keep_mask_is_the_plain_hash(card):
    """With q = k = 0 every causal weight is 1/(tq+1), and v[m, s, h, j] =
    [j == s] puts weight s of head h in output lane h*Dh + s: the kernel's
    own mask, read back."""
    q, *_ = cases.attention_inputs(card, seed=5)
    rows, t, d = q.shape
    hd = d // HEADS
    zeros = torch.zeros(rows, t, d, device=card)
    v = torch.zeros(rows, t, HEADS, hd, device=card)
    idx = torch.arange(t, device=card)
    v[:, idx, :, idx] = 1.0
    v = v.reshape(rows, t, d)
    causal = torch.ones(t, t, dtype=torch.bool, device=card).tril()
    unscale = (idx + 1.0)[None, :, None, None] * (1.0 - P)

    def kernel_mask(seed: int) -> torch.Tensor:  # (M, H, Tq, Ts)
        out = ops.short_attention_forward(zeros, zeros, v, HEADS, P, seed)
        return (out.reshape(rows, t, HEADS, hd)[..., :t] * unscale > 0.5).permute(0, 2, 1, 3) & causal

    mask, other = kernel_mask(SEED), kernel_mask(SEED + 1)
    assert torch.equal(mask, (dropout_bits(SEED, rows, HEADS, t, card) >= dropout_threshold(P)) & causal)
    draws = rows * HEADS * int(causal.sum())
    assert abs(float(mask.sum()) / draws - (1.0 - P)) <= KEPT_TOL
    assert float((mask != other).sum()) / draws >= 0.1, "the mask does not change with the seed"
