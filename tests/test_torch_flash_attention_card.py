"""The flash attention CUDA kernel (csrc/flash_attention.cu) on the card,
against its plain version (ops/flash_attention.py:flash_attention_reference),
on q, k, v that are views of one c_attn output as the model hands them over
(card_cases.flash_views): at card_cases.py's FLASH_CASES in their dtypes, one
launch a call; at the byte LM's pretraining shape also with dropout p = 0.1
and on views that are not 16-byte aligned (the wrapper copies them), its bare
C entry giving the wrapper's bits, and its keep mask, read back through its
output, equal to the plain hash's bit for bit, keeping 1 - p of the draws and
changing with the seed.

On the card: ``python -m pytest tests/test_torch_flash_attention_card.py -m
cuda --noconftest``; every case skips without one."""

import pytest
import torch

from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_threshold
import card_cases as cases
from card_cases import launched
from torch_card import DTYPES, KEPT_TOL, assert_close, card  # noqa: F401 (card: a fixture)

pytestmark = pytest.mark.cuda

P, SEED = cases.DROPOUT, cases.DROPOUT_SEED
B, T, CAUSAL, HD, _ = cases.FLASH_CASES["path"]


@pytest.mark.parametrize("label, dtype", [(label, d) for label, case in cases.FLASH_CASES.items() for d in case[-1]])
def test_kernel_matches_the_plain_version(card, label, dtype):
    b, t, causal, hd, _ = cases.FLASH_CASES[label]
    q, k, v = cases.flash_views(b, t, hd, DTYPES[dtype], card, seed=7)
    ops.reset_counts()
    got = ops.flash_attention_forward(q, k, v, causal)
    assert launched(ops.launch_counts(), "flash_attention") == {"flash_attention": 1}
    assert_close(got, ops.flash_attention_reference(q, k, v, causal), dtype)


@pytest.mark.parametrize("rate, pad", [(P, 0), (0.0, 1)])
def test_dropout_and_unaligned_views_match_the_plain_version(card, rate, pad):
    """The pretraining call's dropout; a 2-byte offset and an odd token stride."""
    q, k, v = cases.flash_views(B, T, HD, torch.bfloat16, card, seed=8, pad=pad)
    got = ops.flash_attention_forward(q, k, v, CAUSAL, rate, SEED)
    assert_close(got, ops.flash_attention_reference(q, k, v, CAUSAL, rate, SEED), "bf16")


def test_bare_entry_gives_the_wrappers_bits(card):
    q, k, v = cases.flash_views(B, T, HD, torch.bfloat16, card, seed=9)
    bare = cases.flash_bare_entry(q, k, v, CAUSAL)
    torch.testing.assert_close(bare(), ops.flash_attention_forward(q, k, v, CAUSAL), rtol=0, atol=0)


def test_dropout_keep_mask_is_the_plain_hash(card):
    """With q = k = 0 every causal weight of query i is 1/(i+1), and for a
    window of 64 keys starting at w, v[b, j, h, c] = [j == w + c] puts key
    w + c's weight in output lane c: the kernel's own mask, read back."""
    heads = cases.FLASH_HEADS
    zeros = torch.zeros(B, T, heads, HD, device=card, dtype=torch.bfloat16)
    unscale = (torch.arange(T, device=card) + 1.0)[None, :, None, None] * (1.0 - P)

    def kernel_mask(seed: int) -> torch.Tensor:  # (B, H, Tq, Tk)
        mask = torch.zeros(B, heads, T, T, dtype=torch.bool, device=card)
        for w in range(0, T, HD):
            width = min(HD, T - w)
            v = torch.zeros_like(zeros)
            idx = torch.arange(width, device=card)
            v[:, w + idx, :, idx] = 1.0
            out = ops.flash_attention_forward(zeros, zeros, v, True, P, seed)
            mask[..., w:w + width] = (out[..., :width].float() * unscale > 0.5).permute(0, 2, 1, 3)
        return mask

    causal = torch.ones(T, T, dtype=torch.bool, device=card).tril()
    mask, other = kernel_mask(SEED) & causal, kernel_mask(SEED + 1) & causal
    assert torch.equal(mask, (dropout_bits(SEED, B, heads, T, card) >= dropout_threshold(P)) & causal)
    draws = B * heads * int(causal.sum())
    assert abs(float(mask.sum()) / draws - (1.0 - P)) <= KEPT_TOL
    assert float((mask != other).sum()) / draws >= 0.1, "the mask does not change with the seed"
