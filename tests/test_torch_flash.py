"""PyTorch port: flash attention against the JAX package's.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel is
held to on the card) against the Pallas ``_attn_kernel`` in interpret mode,
and the port's autograd function against ``jax.grad`` through
``reference_attention``. Inputs come from a numpy seed.

Tolerances: fp32 to 2e-5 absolute (fp32 sums in another order, as the JAX
package's own kernel test allows). bf16 to one bf16 ulp of the output (2^-8
relative, |out| < 2): both sides compute fp32 scores and softmax and round the
probabilities and the output to bf16, so a sum taken in another order can move
an output across one rounding boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.ops.flash_attention import flash_attention_interpret, reference_attention
from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models import gpt2
from tec_mollm_tpu_torch.ops.flash_attention import flash_attention_forward

FP32_ATOL = 2e-5
BF16_ULP = 2.0**-8


def _qkv(t, b=2, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed + t)
    return [rng.normal(0, 0.5, size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _pallas(q, k, v, causal, dtype=jnp.float32):
    with jax.disable_jit():
        out = flash_attention_interpret(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    return ops.flash_attention_reference(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal).float().numpy()


class TestPlainVersion:
    @pytest.mark.parametrize(
        "t,causal",
        # 129 is ragged against any tile; 300 makes the JAX wrapper pad to 512
        # and mask keys >= t_valid (non-causal, where the padding would show)
        [(128, True), (129, True), (129, False), (200, False), (300, False)],
    )
    def test_matches_pallas_fp32(self, t, causal):
        q, k, v = _qkv(t)
        np.testing.assert_allclose(_port(q, k, v, causal), _pallas(q, k, v, causal), atol=FP32_ATOL, rtol=0)

    @pytest.mark.parametrize("t,causal", [(129, True), (200, False)])
    def test_matches_pallas_bf16(self, t, causal):
        q, k, v = _qkv(t, d=64)
        got = _port(q, k, v, causal, torch.bfloat16)
        want = _pallas(q, k, v, causal, jnp.bfloat16)
        np.testing.assert_allclose(got, want, atol=BF16_ULP, rtol=BF16_ULP)

    def test_causality(self):
        """Changing the last key and value moves only the last query's output."""
        q, k, v = _qkv(129)
        k2, v2 = k.copy(), v.copy()
        k2[:, -1] *= 100
        v2[:, -1] += 50
        a, b = _port(q, k, v, True), _port(q, k2, v2, True)
        np.testing.assert_array_equal(a[:, :-1], b[:, :-1])
        assert not np.allclose(a[:, -1], b[:, -1])


class TestFunction:
    @pytest.mark.parametrize("t,causal", [(129, True), (200, False)])
    def test_gradients_match_jax_grad_of_the_reference(self, t, causal):
        """fp32: the backward recomputes the plain version, which in fp32 is
        JAX's ``reference_attention``."""
        q, k, v = _qkv(t, seed=1)
        g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
        want = jax.grad(
            lambda a, b, c: jnp.sum(reference_attention(a, b, c, causal) * g), argnums=(0, 1, 2)
        )(*(jnp.asarray(a) for a in (q, k, v)))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = ops.flash_attention(tq, tk, tv, causal=causal)
        out.backward(torch.from_numpy(g))
        for got, w in zip((tq, tk, tv), want):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=FP32_ATOL, rtol=1e-4)

    def test_cpu_tensor_takes_the_plain_version_without_a_launch(self):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(129))
        ops.reset_counts()
        out = ops.flash_attention(q, k, v)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        torch.testing.assert_close(out, ops.flash_attention_reference(q, k, v), rtol=0, atol=0)
        assert ops.launch_counts() == {}

    def test_short_sequences_route_to_the_plain_version(self):
        """T < FLASH_MIN_SEQ is the plain version on any device, as JAX routes
        short sequences to its reference: no function, no launch, no build."""
        q, k, v = (torch.from_numpy(a) for a in _qkv(ops.FLASH_MIN_SEQ - 1))
        ops.reset_counts()
        torch.testing.assert_close(ops.flash_attention(q, k, v), ops.flash_attention_reference(q, k, v), rtol=0, atol=0)
        meta = torch.empty(2, 64, 2, 32, device="meta", requires_grad=True)
        assert type(ops.flash_attention(meta, meta, meta).grad_fn).__name__ != "_FlashAttentionBackward"
        assert ops.launch_counts() == {}

    def test_strided_views_of_one_projection(self):
        """The model hands the function q, k, v as views of the c_attn output;
        the gradient reaches that tensor."""
        b, t, h, dh = 2, 130, 2, 32
        qkv = torch.from_numpy(np.random.default_rng(5).normal(size=(b, t, 3 * h * dh)).astype(np.float32))
        qkv.requires_grad_()
        q, k, v = (a.reshape(b, t, h, dh) for a in qkv.split(h * dh, dim=-1))
        out = ops.flash_attention(q, k, v)
        want = ops.flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        out.sum().backward()
        assert qkv.grad.shape == qkv.shape and qkv.grad.abs().sum() > 0

    def test_device_tensor_never_falls_back(self):
        """A tensor off the CPU at T >= 128 goes to the kernel or raises:
        shapes and dtypes the kernel does not take raise before any build, and
        without a CUDA toolchain the build itself raises."""
        t = ops.FLASH_MIN_SEQ + 1

        def meta(d=64, dtype=torch.float32):
            return torch.empty(2, t, 3, d, device="meta", dtype=dtype)

        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(meta(48), meta(48), meta(48))
        with pytest.raises(TypeError, match="bf16 or fp32"):
            ops.flash_attention(*(meta(dtype=torch.float16) for _ in range(3)))
        with pytest.raises(ValueError, match="unit stride"):
            strided = torch.empty(2, t, 3, 128, device="meta")[..., ::2]
            ops.flash_attention(strided, strided, strided)
        with pytest.raises(ValueError, match="match q"):
            ops.flash_attention(meta(), meta(), torch.empty(2, t, 4, 64, device="meta"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="nvcc|CUDA"):
                ops.flash_attention(meta(), meta(), meta())

    def test_raw_launcher_refuses_a_call_that_needs_a_gradient(self):
        q = torch.empty(2, 129, 2, 64, device="meta", requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention_forward(q, q, q)


class TestModelRoute:
    """GPT2Attention's branch order is JAX's: fused_attn for t <= 8, then
    use_flash for t > 8, then unrolled, then einsum."""

    @pytest.mark.parametrize(
        "t,use_flash,fused_attn,want_flash",
        [(129, True, False, True), (129, True, True, True), (9, True, False, True),
         (8, True, False, False), (3, True, True, False), (129, False, False, False)],
    )
    def test_branches(self, monkeypatch, t, use_flash, fused_attn, want_flash):
        calls = []

        def spy(*args, **kwargs):
            calls.append(args[0].shape)
            return ops.flash_attention(*args, **kwargs)

        monkeypatch.setattr(gpt2, "flash_attention", spy)
        cfg = ModelConfig(d_llm=32, llm_heads=4, llm_layers=1, lora_r=0, llm_dropout=0.0)
        attn = gpt2.GPT2Attention(cfg, fused_attn=fused_attn, use_flash=use_flash)
        attn.c_attn.reset_parameters(torch.Generator().manual_seed(0))
        attn.c_proj.reset_parameters(torch.Generator().manual_seed(1))
        x = torch.from_numpy(np.random.default_rng(t).normal(size=(2, t, 32)).astype(np.float32))
        out = attn(x)
        assert calls == ([(2, t, 4, 8)] if want_flash else [])
        # every branch computes the same attention in fp32
        plain = gpt2.GPT2Attention(cfg)
        plain.load_state_dict(attn.state_dict())
        torch.testing.assert_close(out, plain(x), atol=2e-6, rtol=1e-5)


def test_forecast_model_is_unchanged_by_use_flash():
    """TECMoLLM threads use_flash to its backbone; at T = 3 patches the flash
    branch is never taken, so the forecast is the same."""
    from tec_mollm_tpu_torch.config import tiny_config
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs

    m = tiny_config().model
    graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
    shifts, valid = graph_inputs(graph, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, m.temporal_seq_len, m.num_nodes, m.in_features)).astype(np.float32))
    tf = torch.zeros(2, m.temporal_seq_len, 4, dtype=torch.int32)
    outs = []
    for use_flash in (False, True):
        model = TECMoLLM(m, shifts, use_flash=use_flash, seed=3).eval()
        assert all(blk.attn.use_flash == use_flash for blk in model.llm_backbone.model.h)
        with torch.no_grad():
            outs.append(model(x, tf, valid))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
