"""PyTorch port: flash attention against the JAX package's.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel is
held to on the card) against the Pallas ``_attn_kernel`` in interpret mode,
and the port's autograd function against ``jax.grad`` through
``reference_attention``. Inputs come from a numpy seed.

Tolerances: fp32 to 2e-5 absolute (fp32 sums in another order, as the JAX
package's own kernel test allows). bf16 to one bf16 ulp of the output (2^-8
relative, |out| < 2): both sides compute fp32 scores and softmax and round the
probabilities and the output to bf16, so a sum taken in another order can move
an output across one rounding boundary.

bf16 gradients against ``jax.grad``: at most one bf16 ulp of the largest
gradient, and at most 1% of the elements differing at all. Both sides round
the same intermediates to bf16 (the scores, the probabilities, each product),
so only a sum taken in another order moves an element by a rounding step; a
backward that keeps the scores in fp32 moves 30 to 50% of them.

Attention dropout (the pretraining path's): the mask is ``dropout_bits`` at
the absolute index ((b*H + h)*T + i)*T + j, kept iff the bits are >= p * 2^32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.ops.flash_attention import flash_attention_interpret, reference_attention
from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.config import ModelConfig
from tec_mollm_tpu_torch.models import gpt2
from tec_mollm_tpu_torch.ops.flash_attention import flash_attention_forward, reference_attention as port_reference
from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_threshold

FP32_ATOL = 2e-5
BF16_ULP = 2.0**-8


def _ulp(x):
    """One bf16 ulp of |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _parent_plain(q, k, v, causal=True):
    """The plain version as it stood before attention dropout was added: the
    rate-0 outputs must stay equal to it bit for bit."""
    t, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    if causal:
        keep = torch.ones(t, k.shape[1], dtype=torch.bool).tril()
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _masked_formula(q, k, v, p, seed, causal=True):
    """Attention with the dropout mask written out: the einsum form with
    dropout_bits applied to the probabilities, scaled by 1/(1-p)."""
    b, t, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    if causal:
        scores = scores.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    keep = dropout_bits(seed, b, h, t) >= dropout_threshold(p)
    probs = probs * keep * (1.0 / (1.0 - p))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


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


class TestRepairs:
    """The flash route against JAX's pretraining: bf16 gradients through JAX's
    reference arithmetic, and the attention dropout of the einsum branch."""

    @pytest.mark.parametrize("t,causal,h,d", [(129, True, 2, 64), (300, False, 3, 32)])
    def test_bf16_gradients_match_jax_grad(self, t, causal, h, d):
        """bf16 gradients of ``flash_attention`` against ``jax.grad`` of the
        Pallas route (``flash_attention_interpret``, whose VJP differentiates
        ``reference_attention`` in bf16)."""
        q, k, v = _qkv(t, h=h, d=d, seed=7)
        g = np.random.default_rng(t).normal(size=q.shape).astype(np.float32)
        gb = jnp.asarray(g, jnp.bfloat16)
        with jax.disable_jit():
            _, vjp = jax.vjp(
                lambda a, b, c: flash_attention_interpret(a, b, c, causal=causal),
                *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            )
            want = [np.asarray(w.astype(jnp.float32)) for w in vjp(gb)]
        tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
        ops.flash_attention(tq, tk, tv, causal=causal).backward(torch.from_numpy(g).bfloat16())
        for got, w in zip((tq, tk, tv), want):
            diff = np.abs(got.grad.float().numpy() - w)
            assert diff.max() <= _ulp(np.abs(w).max())
            assert (diff > 0).mean() <= 0.01

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("t,causal", [(129, True), (300, False)])
    def test_rate_zero_is_unchanged(self, dtype, t, causal):
        """At rate 0 the plain version and the wrapper give the output they
        gave before dropout was added, bit for bit, and agree with the Pallas
        kernel as before."""
        q, k, v = _qkv(t, h=4, d=64)
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        before = _parent_plain(tq, tk, tv, causal)
        torch.testing.assert_close(ops.flash_attention_reference(tq, tk, tv, causal, 0.0, 123), before, rtol=0, atol=0)
        torch.testing.assert_close(ops.flash_attention(tq, tk, tv, causal, dropout_rate=0.0), before, rtol=0, atol=0)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        tol = FP32_ATOL if dtype == torch.float32 else BF16_ULP
        np.testing.assert_allclose(before.float().numpy(), _pallas(q, k, v, causal, jdt), atol=tol, rtol=0 if dtype == torch.float32 else BF16_ULP)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dropout_forward_is_the_masked_formula(self, dtype):
        """At p = 0.1 the plain forward is the einsum form with the
        dropout_bits mask on the probabilities; the kept share is 0.9 within
        4 standard deviations, and another seed draws another mask."""
        p, seed = 0.1, 2024
        b, t, h, d = 2, 128, 2, 32
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in _qkv(t, b=b, h=h, d=d, seed=3))
        got = ops.flash_attention_reference(tq, tk, tv, True, p, seed)
        torch.testing.assert_close(got, _masked_formula(tq, tk, tv, p, seed), rtol=0, atol=0)
        torch.testing.assert_close(ops.flash_attention(tq, tk, tv, True, p, seed), got, rtol=0, atol=0)
        keep = (dropout_bits(seed, b, h, t) >= dropout_threshold(p))[..., torch.ones(t, t, dtype=torch.bool).tril()]
        n = keep.numel()
        assert abs(float(keep.float().mean()) - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
        other = ops.flash_attention_reference(tq, tk, tv, True, p, seed + 1)
        assert (other != got).float().mean() > 0.5
        assert not torch.equal(got, ops.flash_attention_reference(tq, tk, tv, True))

    def test_dropout_backward(self):
        """In fp64, the backward with dropout against autograd through the
        masked formula, and against a central finite difference of the
        function it differentiates (JAX's reference arithmetic) along a random
        direction. That function takes its softmax in fp32, as JAX's does, so
        the gradients agree to fp32 rounding (rtol 1e-5) and the difference
        quotient, over a step of 1e-3, to 1e-4."""
        p, seed = 0.1, 99
        q, k, v = (a.astype(np.float64) for a in _qkv(128, b=1, h=2, d=32, seed=4))
        g = torch.from_numpy(np.random.default_rng(5).normal(size=q.shape))
        got = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        ops.flash_attention(*got, True, p, seed).backward(g)
        want = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        _masked_formula_fp64(*want, p, seed).backward(g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a.grad, w.grad, rtol=1e-5, atol=1e-7)
        dirs = [torch.from_numpy(np.random.default_rng(6 + i).normal(size=q.shape)) for i in range(3)]
        eps = 1e-3

        def f(sign):
            args = [torch.from_numpy(a) + sign * eps * u for a, u in zip((q, k, v), dirs)]
            return float((port_reference(*args, True, p, seed) * g).sum())

        fd = (f(1) - f(-1)) / (2 * eps)
        analytic = sum(float((a.grad * u).sum()) for a, u in zip(got, dirs))
        assert fd == pytest.approx(analytic, rel=1e-4)


def _masked_formula_fp64(q, k, v, p, seed):
    b, t, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d**0.5
    scores = scores.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    keep = dropout_bits(seed, b, h, t) >= dropout_threshold(p)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1) * keep / (1.0 - p), v)


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


def test_flash_branch_drops_attention_probabilities_in_training(monkeypatch):
    """GPT2Attention(use_flash=True) in train mode passes llm_dropout and a
    fresh seed from the default generator to the flash call, so its attention
    output changes with the seed; in eval mode it passes rate 0 and gives the
    output of the route before dropout was added."""
    calls = []

    def spy(q, k, v, causal=True, dropout_rate=0.0, seed=0):
        out = ops.flash_attention(q, k, v, causal, dropout_rate, seed)
        calls.append((dropout_rate, seed, out))
        return out

    monkeypatch.setattr(gpt2, "flash_attention", spy)
    cfg = ModelConfig(d_llm=64, llm_heads=2, llm_layers=1, lora_r=0, llm_dropout=0.1)
    attn = gpt2.GPT2Attention(cfg, use_flash=True)
    attn.c_attn.reset_parameters(torch.Generator().manual_seed(0))
    attn.c_proj.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 129, 64)).astype(np.float32))
    attn.train()
    for s in (0, 1):
        torch.manual_seed(s)
        attn(x)
    (p0, seed0, out0), (p1, seed1, out1) = calls
    assert p0 == p1 == 0.1 and seed0 != seed1
    assert not torch.equal(out0, out1)
    with torch.no_grad():
        q, k, v = (a.reshape(2, 129, 2, 32) for a in attn.c_attn(x).split(64, dim=-1))
        want = attn.c_proj(_parent_plain(q, k, v).reshape(2, 129, 64))
        got = attn.eval()(x)
    assert calls[-1][0] == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_forecast_model_is_unchanged_by_use_flash():
    """TECMoLLM threads use_flash to its backbone; at T = 3 patches the flash
    branch is never taken, so the forecast is the same."""
    from tec_mollm_tpu_torch.config import tiny_config
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
    from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs

    m = tiny_config().model
    graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
    shifts, graph_pair = graph_inputs(graph, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, m.temporal_seq_len, m.num_nodes, m.in_features)).astype(np.float32))
    tf = torch.zeros(2, m.temporal_seq_len, 4, dtype=torch.int32)
    outs = []
    for use_flash in (False, True):
        model = TECMoLLM(m, shifts, use_flash=use_flash, seed=3).eval()
        assert all(blk.attn.use_flash == use_flash for blk in model.llm_backbone.model.h)
        with torch.no_grad():
            outs.append(model(x, tf, *graph_pair))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
