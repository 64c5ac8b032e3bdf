"""PyTorch port: each kernel's plain version against the JAX Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as tests/test_ops.py runs
them; the port's wrappers take their plain version for CPU tensors. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py. fp32 tolerances cover the order of fp32 sums (about 1e-6
relative at these sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.data.synthetic import grid_coordinates
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.ops.fused_mlp import fused_ln_mlp_interpret
from tec_mollm_tpu.ops.gat_stencil import gat_stencil_attention as jax_gat_stencil
from tec_mollm_tpu.ops.short_attention import fused_short_causal_attention
from tec_mollm_tpu_torch import ops


@pytest.fixture(scope="module")
def padded_stencil():
    """The 6x8 grid's stencil with 16 extra all-invalid lanes (as pad_nodes_to adds)."""
    g = build_graph(*grid_coordinates(6, 8))
    n_real = g.num_nodes
    valid = np.zeros((len(g.stencil_shifts), n_real + 16), bool)
    valid[:, :n_real] = g.stencil_valid
    return tuple(int(s) for s in g.stencil_shifts), valid, n_real


def _gat_inputs(seed, m, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xl = rng.normal(size=(m, 22, n)).astype(dtype)
    xr = rng.normal(size=(m, 22, n)).astype(dtype)
    att = rng.normal(0, 0.5, size=(2, 11)).astype(np.float32)
    return xl, xr, att


class TestGATStencil:
    @pytest.mark.parametrize("slope", [0.2, 0.01])
    def test_plain_matches_pallas_on_real_lanes(self, padded_stencil, slope):
        shifts, valid, n_real = padded_stencil
        xl, xr, att = _gat_inputs(0, 3, valid.shape[1])
        want = np.asarray(jax_gat_stencil(
            jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(valid), jnp.asarray(att), shifts,
            negative_slope=slope, interpret=True,
        ))
        got = ops.gat_stencil_reference(
            torch.from_numpy(xl), torch.from_numpy(xr), torch.from_numpy(valid),
            torch.from_numpy(att), shifts, slope,
        ).numpy()
        np.testing.assert_allclose(got[..., :n_real], want[..., :n_real], atol=2e-6, rtol=1e-5)
        # the Pallas body divides 0/0 on lanes with no valid offset; the port floors
        assert np.isnan(want[..., n_real:]).all()
        np.testing.assert_array_equal(got[..., n_real:], 0.0)

    def test_wrapper_on_cpu_is_the_plain_version(self, padded_stencil):
        shifts, valid, _ = padded_stencil
        xl, xr, att = (torch.from_numpy(a) for a in _gat_inputs(1, 2, valid.shape[1]))
        v = torch.from_numpy(valid)
        torch.testing.assert_close(
            ops.gat_stencil_attention(xl, xr, v, att, shifts),
            ops.gat_stencil_reference(xl, xr, v, att, shifts), rtol=0, atol=0,
        )

    def test_bf16_plain_matches_pallas(self, padded_stencil):
        """bf16 in and out, fp32 inside, on both sides: equal up to one bf16
        rounding of the output (2^-8 relative)."""
        shifts, valid, n_real = padded_stencil
        xl, xr, att = _gat_inputs(2, 2, valid.shape[1])
        want = jax_gat_stencil(
            jnp.asarray(xl, jnp.bfloat16), jnp.asarray(xr, jnp.bfloat16), jnp.asarray(valid),
            jnp.asarray(att), shifts, interpret=True,
        )
        got = ops.gat_stencil_reference(
            torch.from_numpy(xl).bfloat16(), torch.from_numpy(xr).bfloat16(),
            torch.from_numpy(valid), torch.from_numpy(att), shifts,
        )
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy()[..., :n_real], np.asarray(want, np.float32)[..., :n_real],
            atol=1e-2, rtol=1e-2,
        )

    def test_device_tensor_never_falls_back(self, padded_stencil):
        """A tensor off the CPU goes to the kernel or raises: shapes the kernel
        does not take raise before any build, and without a CUDA toolchain the
        build itself raises."""
        shifts, valid, _ = padded_stencil
        n = valid.shape[1]
        xl = torch.empty(2, 22, n, device="meta")
        v = torch.empty(len(shifts), n, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="2 heads x 11"):
            ops.gat_stencil_attention(xl, xl, v, torch.empty(1, 22, device="meta"), shifts)
        with pytest.raises(TypeError, match="bool"):
            ops.gat_stencil_attention(xl, xl, v.float(), torch.empty(2, 11), shifts)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="nvcc|CUDA"):
                ops.gat_stencil_attention(xl, xl, v, torch.empty(2, 11), shifts)


def _qkv(seed, m, t, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.7, size=(m, t, d)).astype(dtype) for _ in range(3)]


class TestShortAttention:
    @pytest.mark.parametrize("t", [1, 2, 3, 5, 8])
    def test_plain_matches_pallas(self, t):
        heads, m, d = 4, 40, 64
        q, k, v = _qkv(t, m, t, d)
        with jax.disable_jit():
            want = np.asarray(fused_short_causal_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads, interpret=True
            ))
        got = ops.short_causal_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads
        ).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)

    def test_strided_views_of_one_projection(self):
        """The model hands the wrapper q, k, v as views of the c_attn output."""
        heads, m, t, d = 2, 16, 3, 64
        qkv = torch.from_numpy(np.random.default_rng(5).normal(size=(m, t, 3 * d)).astype(np.float32))
        q, k, v = qkv.split(d, dim=-1)
        got = ops.short_causal_attention(q, k, v, heads)
        want = ops.short_causal_attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), heads)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_dropout_is_refused(self):
        q = torch.zeros(2, 3, 64)
        with pytest.raises(NotImplementedError):
            ops.short_causal_attention(q, q, q, 2, dropout_rate=0.1)

    def test_device_checks(self):
        q = torch.empty(4, 9, 64, device="meta")
        with pytest.raises(ValueError, match="T <= 8"):
            ops.short_causal_attention(q, q, q, 2)
        q = torch.empty(4, 3, 64, device="meta")
        with pytest.raises(ValueError, match="strides"):
            ops.short_causal_attention(q, q, torch.empty(4, 3, 128, device="meta")[..., :64], 2)


class TestFusedMLP:
    @staticmethod
    def _inputs(seed, rows, d, dtype=np.float32):
        rng = np.random.default_rng(seed)
        dh = 4 * d
        return (
            rng.normal(size=(rows, d)).astype(dtype),
            (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32),
            (0.05 * rng.normal(size=(d, dh))).astype(np.float32),
            (0.05 * rng.normal(size=dh)).astype(np.float32),
            (0.05 * rng.normal(size=(dh, d))).astype(np.float32),
            (0.05 * rng.normal(size=d)).astype(np.float32),
        )

    @pytest.mark.parametrize("rows", [96, 300])
    def test_plain_matches_pallas(self, rows):
        args = self._inputs(rows, rows, 64)
        want = np.asarray(fused_ln_mlp_interpret(*(jnp.asarray(a) for a in args)))
        got = ops.fused_ln_mlp_reference(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)

    def test_bf16_plain_matches_pallas(self):
        """bf16 x: LN output and GELU output rounded to bf16 on both sides; fp32
        accumulation. Agreement to one bf16 rounding of the output."""
        args = self._inputs(7, 64, 64)
        jargs = [jnp.asarray(args[0], jnp.bfloat16)] + [jnp.asarray(a) for a in args[1:]]
        want = np.asarray(fused_ln_mlp_interpret(*jargs), np.float32)
        targs = [torch.from_numpy(args[0]).bfloat16()] + [torch.from_numpy(a) for a in args[1:]]
        got = ops.fused_ln_mlp_reference(*targs)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)

    def test_device_checks(self):
        x = torch.empty(8, 64, device="meta")
        w1, w2 = torch.empty(64, 256), torch.empty(256, 64)
        v = torch.empty(64)
        with pytest.raises(TypeError, match="bf16"):
            ops.fused_ln_mlp(x, v, v, w1, torch.empty(256), w2, v)
        with pytest.raises(ValueError, match="multiples of 128"):
            ops.fused_ln_mlp(x.bfloat16(), v, v, w1, torch.empty(256), w2, v)


def test_launch_counts_start_empty_and_reset():
    ops.reset_counts()
    assert ops.launch_counts() == {}
