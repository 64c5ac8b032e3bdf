"""PyTorch port: each kernel's plain version against the JAX Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as tests/test_ops.py runs
them; the port's wrappers take their plain version for CPU tensors. The CUDA
kernels themselves are held against these plain versions on the card by
the ``cuda`` cases of their own test files (tests/test_torch_*_card.py).
fp32 tolerances cover the order of fp32 sums (about 1e-6 relative at these
sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tec_mollm_tpu.data.synthetic import grid_coordinates
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.graph.builder import build_grid_stencil as jax_build_grid_stencil
from tec_mollm_tpu.ops.fused_mlp import fused_ln_mlp_interpret
from tec_mollm_tpu.ops.gat_stencil import gat_stencil_attention as jax_gat_stencil
from tec_mollm_tpu.ops.short_attention import fused_short_causal_attention
from tec_mollm_tpu_torch import ops
from tec_mollm_tpu_torch.graph import grid_coordinates as port_grid_coordinates
from tec_mollm_tpu_torch.graph.builder import build_grid_stencil
from tec_mollm_tpu_torch.ops.gat_stencil import MAX_OFFSETS, MAX_SHIFT, check_stencil, tiled_takes
from tec_mollm_tpu_torch.ops.short_attention import dropout_bits, dropout_keep, dropout_threshold


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

    def test_refuses_a_call_that_needs_a_gradient(self, padded_stencil):
        """No backward, as in the Pallas kernel: grad mode plus an input that
        requires grad raises, on the CPU as on the card; no_grad runs."""
        shifts, valid, _ = padded_stencil
        xl, xr, att = (torch.from_numpy(a) for a in _gat_inputs(3, 2, valid.shape[1]))
        v = torch.from_numpy(valid)
        for leaf in ("xl", "att"):
            args = {"xl": xl, "xr": xr, "att": att}
            args[leaf] = args[leaf].clone().requires_grad_()
            with pytest.raises(RuntimeError, match="no backward"):
                ops.gat_stencil_attention(args["xl"], args["xr"], v, args["att"], shifts)
            with torch.no_grad():
                out = ops.gat_stencil_attention(args["xl"], args["xr"], v, args["att"], shifts)
            assert not out.requires_grad
        meta = torch.empty(2, 22, valid.shape[1], device="meta", requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.gat_stencil_attention(meta, meta, v.to("meta"), att, shifts)

    def test_device_tensor_never_falls_back(self, padded_stencil):
        """A tensor off the CPU goes to the kernel or raises: shapes the kernel
        does not take raise before any build, and without a CUDA toolchain the
        build itself raises, for the tiled layout and for the general form's
        (1 head x 22 channels)."""
        shifts, valid, _ = padded_stencil
        n = valid.shape[1]
        xl = torch.empty(2, 22, n, device="meta")
        v = torch.empty(len(shifts), n, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match="does not fit 22 channels"):
            ops.gat_stencil_attention(xl, xl, v, torch.empty(2, 7, device="meta"), shifts)
        with pytest.raises(TypeError, match="bool"):
            ops.gat_stencil_attention(xl, xl, v.float(), torch.empty(2, 11), shifts)
        if not torch.cuda.is_available():
            for att in (torch.empty(2, 11), torch.empty(1, 22)):
                with pytest.raises(RuntimeError, match="nvcc|CUDA"):
                    ops.gat_stencil_attention(xl, xl, v, att, shifts)


# the flagship 41x71 grid's two stencils: 150 km (the default, O = 11, largest
# |shift| 72) and 300 km (long_horizon, O = 33, largest |shift| 144)
FLAGSHIP_RADII_KM = (150.0, 300.0)


@pytest.fixture(scope="module")
def flagship_stencils():
    out = {}
    for km in FLAGSHIP_RADII_KM:
        shifts, valid = build_grid_stencil(*port_grid_coordinates(41, 71), km)
        out[km] = (tuple(int(s) for s in shifts), valid)
    return out


class TestGATStencilFlagship:
    """The plain version against the Pallas kernel on the stencils the model
    runs, and the preconditions of the CUDA kernel's halo and zero fill."""

    @pytest.mark.parametrize("km", FLAGSHIP_RADII_KM)
    def test_plain_matches_pallas_fp32(self, flagship_stencils, km):
        shifts, valid = flagship_stencils[km]
        xl, xr, att = _gat_inputs(10, 2, valid.shape[1])
        want = np.asarray(jax_gat_stencil(
            jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(valid), jnp.asarray(att), shifts, interpret=True,
        ))
        got = ops.gat_stencil_reference(
            torch.from_numpy(xl), torch.from_numpy(xr), torch.from_numpy(valid), torch.from_numpy(att), shifts,
        ).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)

    @pytest.mark.parametrize("km", FLAGSHIP_RADII_KM)
    def test_plain_matches_pallas_bf16(self, flagship_stencils, km):
        """bf16 in and out, fp32 inside: equal up to one bf16 rounding."""
        shifts, valid = flagship_stencils[km]
        xl, xr, att = _gat_inputs(11, 2, valid.shape[1])
        want = jax_gat_stencil(
            jnp.asarray(xl, jnp.bfloat16), jnp.asarray(xr, jnp.bfloat16), jnp.asarray(valid),
            jnp.asarray(att), shifts, interpret=True,
        )
        got = ops.gat_stencil_reference(
            torch.from_numpy(xl).bfloat16(), torch.from_numpy(xr).bfloat16(), torch.from_numpy(valid),
            torch.from_numpy(att), shifts,
        )
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)

    @pytest.mark.parametrize("km", FLAGSHIP_RADII_KM)
    @pytest.mark.parametrize("builder", ["port", "jax"])
    def test_mask_marks_no_out_of_range_neighbour(self, km, builder):
        """The kernel zero-fills (and counts as invalid) a neighbour outside
        [0, N) where the Pallas roll wraps around: the two agree because the
        builder never marks such a neighbour valid."""
        if builder == "port":
            shifts, valid = build_grid_stencil(*port_grid_coordinates(41, 71), km)
        else:
            shifts, valid = jax_build_grid_stencil(*grid_coordinates(41, 71), km)
        n = valid.shape[1]
        assert n == 41 * 71 and len(shifts) == {150.0: 11, 300.0: 33}[km]
        assert max(abs(int(s)) for s in shifts) == {150.0: 72, 300.0: 144}[km]
        neighbour = np.arange(n)[None, :] + np.asarray(shifts)[:, None]
        assert not (valid & ((neighbour < 0) | (neighbour >= n))).any()
        assert valid[list(shifts).index(0)].all()


def _kernel_takes(shifts) -> bool:
    """What the kernel takes, in numpy: at least one offset, each shift a 32-bit
    int. Its tiled form takes 1 to 64 offsets (a node's validity bits are one
    uint64) and no |shift| beyond its largest halo, 144 nodes; the general
    form the rest."""
    return len(shifts) >= 1 and bool(np.abs(np.asarray(shifts, np.int64)).max() <= 2**31 - 1)


def _tiled_takes(shifts) -> bool:
    return 1 <= len(shifts) <= 64 and bool(np.abs(np.asarray(shifts, np.int64)).max() <= 144)


class TestCheckStencil:
    @pytest.mark.parametrize("seed", range(8))
    def test_matches_numpy(self, seed):
        """Random stencils around the tiled form's limits: check_stencil takes
        exactly the ones the numpy rule takes and returns their shifts as ints,
        and tiled_takes picks the tiled form exactly where the numpy rule does."""
        rng = np.random.default_rng(seed)
        for _ in range(50):
            o = int(rng.integers(0, MAX_OFFSETS + 8))
            reach = MAX_SHIFT + int(rng.integers(0, 2)) * 8  # half the draws stay in range
            shifts = rng.integers(-reach, reach + 1, size=o)
            if _kernel_takes(shifts):
                got = check_stencil(shifts)
                assert got == tuple(int(s) for s in shifts) and all(type(s) is int for s in got)
                assert (tiled_takes(got) is None) == _tiled_takes(shifts), shifts
            else:
                with pytest.raises(ValueError, match="stencil kernel takes"):
                    check_stencil(shifts)

    @pytest.mark.parametrize("km", FLAGSHIP_RADII_KM)
    def test_takes_the_flagship_stencils(self, flagship_stencils, km):
        shifts, _ = flagship_stencils[km]
        assert check_stencil(np.asarray(shifts)) == shifts
        assert max(map(abs, shifts)) == {150.0: 72, 300.0: 144}[km] <= MAX_SHIFT
        assert tiled_takes(shifts) is None

    @pytest.mark.parametrize("shifts, match", [
        (tuple(range(MAX_OFFSETS + 1)), "1 to 64 offsets"),
        ((), "1 to 64 offsets"),
        ((0, MAX_SHIFT + 1), "shifts up to 144"),
        ((-MAX_SHIFT - 1, 0), "shifts up to 144"),
    ])
    def test_refuses_what_the_kernel_does_not_take(self, shifts, match):
        """Past the tiled form's limits (with the reason) the general form
        takes the stencil; only a stencil without an offset, or with a shift
        beyond 32 bits, is refused."""
        reason = tiled_takes(shifts)
        assert reason is not None and match in reason
        if shifts:
            assert check_stencil(shifts) == shifts
        else:
            with pytest.raises(ValueError, match="at least one offset"):
                check_stencil(shifts)
        with pytest.raises(ValueError, match="shifts up to 2147483647"):
            check_stencil((0, 2**31))
        assert check_stencil(tuple(range(MAX_OFFSETS))) == tuple(range(MAX_OFFSETS))
        assert check_stencil((-MAX_SHIFT, 0, MAX_SHIFT)) == (-MAX_SHIFT, 0, MAX_SHIFT)
        assert tiled_takes((-MAX_SHIFT, 0, MAX_SHIFT)) is None

    @pytest.mark.parametrize("shifts, match", [
        ((), "at least one offset"),
        ((0, 1, 2**31), "shifts up to 2147483647"),
    ])
    def test_wrapper_refuses_before_any_build(self, shifts, match):
        """A device tensor with a stencil the kernel does not take raises in
        the wrapper, before nvcc."""
        n = 128
        xl = torch.empty(2, 22, n, device="meta")
        v = torch.empty(len(shifts), n, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError, match=match):
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
        """Attention dropout is supported in [0, 1); a rate outside is refused."""
        q = torch.zeros(2, 3, 64)
        for rate in (-0.1, 1.0):
            with pytest.raises(ValueError, match="dropout_rate"):
                ops.short_causal_attention(q, q, q, 2, dropout_rate=rate)

    def test_device_checks(self):
        q = torch.empty(4, 9, 64, device="meta")
        with pytest.raises(ValueError, match="T <= 8"):
            ops.short_causal_attention(q, q, q, 2)
        q = torch.empty(4, 3, 64, device="meta")
        with pytest.raises(ValueError, match="strides"):
            ops.short_causal_attention(q, q, torch.empty(4, 3, 128, device="meta")[..., :64], 2)


class TestShortAttentionBackward:
    """The plain backward against the Pallas ``_bwd_kernel`` (interpret mode)
    and the autograd function against autograd through the plain forward. All
    fp32; tolerances cover fp32 sums in another order."""

    @pytest.mark.parametrize("t", [1, 3, 8])
    def test_plain_backward_matches_pallas_vjp(self, t):
        heads, m, d = 4, 40, 64
        q, k, v = _qkv(10 + t, m, t, d)
        g = np.random.default_rng(t).normal(size=(m, t, d)).astype(np.float32)
        with jax.disable_jit():
            _, vjp = jax.vjp(
                lambda q, k, v: fused_short_causal_attention(q, k, v, heads=heads, interpret=True),
                *(jnp.asarray(a) for a in (q, k, v)),
            )
            want = np.concatenate([np.asarray(a) for a in vjp(jnp.asarray(g))], axis=-1)
        got = ops.short_causal_attention_backward_reference(
            *(torch.from_numpy(a) for a in (q, k, v, g)), heads
        ).numpy()
        assert got.shape == (m, t, 3 * d)
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    def test_function_gradients_match_autograd_through_the_plain_forward(self, rate):
        """q, k, v as views of one (M, T, 3D) projection, as the model gives
        them: the function's gradient reaches it as one tensor."""
        heads, m, t, d = 4, 24, 3, 64
        rng = np.random.default_rng(3)
        base = rng.normal(0, 0.7, size=(m, t, 3 * d)).astype(np.float32)
        g = torch.from_numpy(rng.normal(size=(m, t, d)).astype(np.float32))
        qkv = torch.from_numpy(base).requires_grad_()
        out = ops.short_causal_attention(*qkv.split(d, dim=-1), heads, dropout_rate=rate, seed=11)
        out.backward(g)
        ref_qkv = torch.from_numpy(base).requires_grad_()
        ref = ops.short_causal_attention_reference(*ref_qkv.split(d, dim=-1), heads, dropout_rate=rate, seed=11)
        ref.backward(g)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close(qkv.grad, ref_qkv.grad, rtol=1e-5, atol=1e-6)
        # separate tensors (no common projection) take the same path
        q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in np.split(base, 3, axis=-1))
        ops.short_causal_attention(q, k, v, heads, dropout_rate=rate, seed=11).backward(g)
        torch.testing.assert_close(torch.cat([q.grad, k.grad, v.grad], dim=-1), ref_qkv.grad, rtol=1e-5, atol=1e-6)


    @pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
    def test_thirds_of_one_projection_are_not_copied(self, mode):
        """The function takes q, k, v as the thirds of the (M, T, 3D) c_attn
        output without concatenating them, in every autograd mode."""
        from tec_mollm_tpu_torch.ops.short_attention import _packed

        x = torch.randn(6, 3, 4 * 64)
        ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]
        w = torch.randn(4 * 64, 3 * 64, requires_grad=True)
        with ctx():
            qkv = x @ w
            q, k, v = qkv.split(64, dim=-1)
            packed = _packed(q, k, v)
            assert packed.data_ptr() == qkv.data_ptr() and packed.shape == qkv.shape
            torch.testing.assert_close(packed, qkv, rtol=0, atol=0)
            if mode == "grad":
                assert packed is qkv
        sep = [a.clone() for a in (q, k, v)]
        assert _packed(*sep).data_ptr() not in {a.data_ptr() for a in sep}  # not views: concatenated


class TestShortAttentionDropout:
    @staticmethod
    def _qkv(m=16, t=3, d=32, seed=21):
        return [torch.from_numpy(a) for a in _qkv(seed, m, t, d)]

    def test_forward_and_backward_share_the_mask(self):
        """Finite differences of the seeded forward against the backward, which
        regenerates the mask (the tolerances of the Pallas kernel's own check,
        tests/test_ops.py): the mask of another seed misses by far more."""
        heads = 2
        q, k, v = self._qkv()
        rng = np.random.default_rng(99)
        cot = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))

        def loss(q, k, v):
            return (ops.short_causal_attention(q, k, v, heads, dropout_rate=0.25, seed=3) * cot).sum()

        params = [a.clone().requires_grad_() for a in (q, k, v)]
        grads = torch.autograd.grad(loss(*params), params)
        dirs = [torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)) for _ in range(3)]
        eps = 1e-2
        plus = loss(*(a + eps * da for a, da in zip((q, k, v), dirs)))
        minus = loss(*(a - eps * da for a, da in zip((q, k, v), dirs)))
        fd = float((plus - minus) / (2 * eps))
        analytic = float(sum((gi * di).sum() for gi, di in zip(grads, dirs)))
        assert analytic == pytest.approx(fd, rel=2e-2, abs=1e-3)
        # the same check through the plain backward with the other seed fails
        other = ops.short_causal_attention_backward_reference(q, k, v, cot, heads, 0.25, seed=4)
        wrong = float(sum((gi * di).sum() for gi, di in zip(other.split(q.shape[-1], dim=-1), dirs)))
        assert abs(wrong - fd) > 0.1 * abs(fd)

    def test_seeds_differ_and_repeat(self):
        q, k, v = self._qkv()
        a = ops.short_causal_attention(q, k, v, 2, dropout_rate=0.3, seed=7)
        b = ops.short_causal_attention(q, k, v, 2, dropout_rate=0.3, seed=7)
        c = ops.short_causal_attention(q, k, v, 2, dropout_rate=0.3, seed=8)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.allclose(a, c)
        assert not torch.equal(dropout_bits(7, 4, 2, 3), dropout_bits(8, 4, 2, 3))

    @pytest.mark.parametrize("rate", [0.1, 0.5])
    def test_kept_fraction(self, rate):
        """Over 2^20 draws the kept share is 1 - p within 5 standard deviations."""
        bits = dropout_bits(123, 4096, 16, 4)
        kept = float((bits >= dropout_threshold(rate)).double().mean())
        assert abs(kept - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / bits.numel())
        assert 0 <= int(bits.min()) and int(bits.max()) < 2**32

    def test_rate_zero_is_the_identity(self):
        q, k, v = self._qkv()
        want = ops.short_causal_attention_reference(q, k, v, 2)
        for seed in (0, 5, 2**31 - 2):
            torch.testing.assert_close(ops.short_causal_attention(q, k, v, 2, 0.0, seed), want, rtol=0, atol=0)
            g = ops.short_causal_attention_backward_reference(q, k, v, q, 2, 0.0, seed)
            torch.testing.assert_close(g, ops.short_causal_attention_backward_reference(q, k, v, q, 2), rtol=0, atol=0)

    def test_hash_matches_uint32_arithmetic(self):
        """The int64 tensor hash is the kernel's uint32 hash: checked against
        numpy's wrapping uint32 arithmetic, index by index."""
        def mix(x):
            x = x.copy()
            with np.errstate(over="ignore"):
                x ^= x >> np.uint32(16)
                x *= np.uint32(0x7FEB352D)
                x ^= x >> np.uint32(15)
                x *= np.uint32(0x846CA68B)
                x ^= x >> np.uint32(16)
            return x

        seed, m, h, t = 2**31 - 5, 7, 3, 5
        key = mix(np.array([seed ^ 0x9E3779B9], np.uint32))[0]
        idx = np.arange(m * h * t * t, dtype=np.uint32)
        want = mix(mix(idx ^ key))  # the high word of every index is 0
        np.testing.assert_array_equal(dropout_bits(seed, m, h, t).numpy().ravel(), want.astype(np.int64))

    @pytest.mark.parametrize("seed", [0, 7, 2**31 - 5, 2**32 - 1])
    @pytest.mark.parametrize("rate", [1e-4, 0.1, 0.5, 0.9999])
    def test_int32_keep_mask_equals_the_int64_hash(self, seed, rate):
        """The plain versions' keep mask (the hash in wrapping int32 arithmetic,
        compared in unsigned order) is the int64 hash's, bit for bit."""
        m, h, t = 5, 3, 37
        want = dropout_bits(seed, m, h, t) >= dropout_threshold(rate)
        torch.testing.assert_close(dropout_keep(seed, rate, m, h, t), want, rtol=0, atol=0)


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

    def test_gradients_match_pallas_vjp(self):
        """The autograd function's backward (recompute through the plain
        version) against jax.vjp of the Pallas kernel's custom VJP."""
        args = self._inputs(5, 96, 64)
        g = np.random.default_rng(6).normal(size=(96, 64)).astype(np.float32)
        _, vjp = jax.vjp(fused_ln_mlp_interpret, *(jnp.asarray(a) for a in args))
        want = vjp(jnp.asarray(g))
        targs = [torch.from_numpy(a).requires_grad_() for a in args]
        out = ops.fused_ln_mlp(*targs)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(g))
        for a, w in zip(targs, want):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)

    def test_device_checks(self):
        x = torch.empty(8, 64, device="meta")
        w1, w2 = torch.empty(64, 256), torch.empty(256, 64)
        v = torch.empty(64)
        with pytest.raises(TypeError, match="bf16"):
            ops.fused_ln_mlp(x, v, v, w1, torch.empty(256), w2, v)
        with pytest.raises(ValueError, match="multiples of 128"):
            ops.fused_ln_mlp(x.bfloat16(), v, v, w1, torch.empty(256), w2, v)


@pytest.mark.parametrize("launcher", ["short_attention_forward", "short_attention_backward", "fused_ln_mlp_forward"])
def test_raw_launchers_refuse_a_call_that_needs_a_gradient(launcher):
    """The launchers fill their outputs outside autograd, so with grad mode on
    and an input that requires grad they raise before any device work; the
    differentiable calls are the autograd functions."""
    from tec_mollm_tpu_torch.ops.fused_mlp import fused_ln_mlp_forward

    q = torch.empty(4, 3, 64, device="meta", requires_grad=True)
    x = torch.empty(8, 128, device="meta", dtype=torch.bfloat16, requires_grad=True)
    w = torch.empty(128, 128, device="meta")
    v = torch.empty(128, device="meta")
    call = {
        "short_attention_forward": lambda: ops.short_attention_forward(q, q, q, 2),
        "short_attention_backward": lambda: ops.short_attention_backward(q, q, q, q, 2),
        "fused_ln_mlp_forward": lambda: fused_ln_mlp_forward(x, v, v, w, v, w, v),
    }[launcher]
    with pytest.raises(RuntimeError, match="no backward"):
        call()


def test_launch_counts_start_empty_and_reset():
    ops.reset_counts()
    assert ops.launch_counts() == {}
