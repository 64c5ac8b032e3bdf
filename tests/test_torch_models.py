"""PyTorch port: every module of the forward against its Flax counterpart.

One tiny JAX model is initialised, every parameter is redrawn from a numpy seed
(so LoRA's B, the year table and the biases are not zero), and the same tree
goes into the port through models/convert.py. Inputs come from numpy. All in
fp32 on the CPU; the tolerances cover fp32 sums taken in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict
from torch.utils.flop_counter import FlopCounterMode

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.synthetic import grid_coordinates
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.models import TECMoLLM as JaxTECMoLLM
from tec_mollm_tpu.models.embeddings import SpatioTemporalEmbedding as JaxEmbedding
from tec_mollm_tpu.models.gat import GATv2Stencil as JaxGATv2Stencil
from tec_mollm_tpu.models.gpt2 import GPT2Backbone as JaxBackbone
from tec_mollm_tpu.models.gpt2 import GPT2Block as JaxBlock
from tec_mollm_tpu.models.head import PredictionHead as JaxHead
from tec_mollm_tpu.models.lora import LoRADense as JaxLoRADense
from tec_mollm_tpu.models.ref_import import reference_state_dict_to_params
from tec_mollm_tpu.models.temporal import MultiScaleConvBlock as JaxConvBlock
from tec_mollm_tpu.models.temporal import TemporalEncoder as JaxTemporal
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs, params_to_state_dict
from tec_mollm_tpu_torch.models.lora import LoRADense
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 3e-5, 1e-4
# bf16 (8 significant bits) against bf16, where the two sides round at other points
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2


def _configs(**model_overrides):
    j, p = jcfg.tiny_config(), pcfg.tiny_config()
    if model_overrides:
        j = dataclasses.replace(j, model=dataclasses.replace(j.model, **model_overrides))
        p = dataclasses.replace(p, model=dataclasses.replace(p.model, **model_overrides))
    return j.model, p.model


def _redraw(params, seed):
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(params), sep="/")
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("/scale"):
            out[k] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("/embedding"):
            out[k] = rng.normal(size=v.shape).astype(np.float32)
        else:
            out[k] = (0.2 * rng.normal(size=v.shape)).astype(np.float32)
    return out


class World:
    """A tiny JAX model with redrawn parameters and the port built from them."""

    def __init__(self, seed=0, pad_nodes_to=32, **model_overrides):
        self.jm, self.pm = _configs(**model_overrides)
        self.graph = build_graph(*grid_coordinates(self.jm.grid_h, self.jm.grid_w))
        self.shifts = tuple(int(s) for s in self.graph.stencil_shifts)
        self.valid = np.asarray(self.graph.stencil_valid)
        m = self.jm
        rng = np.random.default_rng(100 + seed)
        self.x = rng.normal(size=(2, m.temporal_seq_len, m.num_nodes, m.in_features)).astype(np.float32)
        self.tf = np.stack([
            rng.integers(0, m.num_tod, size=(2, m.temporal_seq_len)),
            rng.integers(0, m.num_doy, size=(2, m.temporal_seq_len)),
            rng.integers(0, m.num_years, size=(2, m.temporal_seq_len)),
            rng.integers(0, m.num_seasons, size=(2, m.temporal_seq_len)),
        ], axis=-1).astype(np.int32)
        self.jax_model = JaxTECMoLLM(m, stencil_shifts=self.shifts, pad_nodes_to=pad_nodes_to)
        init = self.jax_model.init(
            jax.random.key(seed), jnp.asarray(self.x), jnp.asarray(self.tf),
            jnp.asarray(self.valid), jnp.asarray(self.valid),
        )["params"]
        self.flat = _redraw(init, seed)
        self.params = unflatten_dict(self.flat, sep="/")
        self.pad_nodes_to = pad_nodes_to

    def port(self, **kwargs):
        model = TECMoLLM(self.pm, self.shifts, pad_nodes_to=self.pad_nodes_to, **kwargs)
        model.load_state_dict(params_to_state_dict(self.flat, self.pm))
        return model.eval()

    def jax_forward(self):
        return np.asarray(self.jax_model.apply(
            {"params": self.params}, jnp.asarray(self.x), jnp.asarray(self.tf),
            jnp.asarray(self.valid), jnp.asarray(self.valid), deterministic=True,
        ))

    def port_forward(self, **kwargs):
        _, graph = graph_inputs(self.graph, "cpu")
        with torch.no_grad():
            return self.port(**kwargs)(torch.from_numpy(self.x), torch.from_numpy(self.tf), *graph).numpy()


@pytest.fixture(scope="module")
def world():
    return World()


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestModules:
    def test_embedding(self, world):
        want = JaxEmbedding(world.jm).apply(
            {"params": world.params["embedding"]}, jnp.asarray(world.x), jnp.asarray(world.tf)
        )
        with torch.no_grad():
            got = world.port().spatio_temporal_embedding(_t(world.x), _t(world.tf))
        _close(got, want, atol=1e-6)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_gat_stencil_with_padded_lanes(self, world, use_kernel):
        """Real lanes match the Flax stencil; the 16 all-invalid padded lanes
        come out as the bias alone (zero attention), finite."""
        m = world.jm
        rng = np.random.default_rng(1)
        n_real, n = m.num_nodes, m.num_nodes + 16
        x = rng.normal(size=(3, n, m.spatial_in_channels)).astype(np.float32)
        valid = np.zeros((len(world.shifts), n), bool)
        valid[:, :n_real] = world.valid
        want = np.asarray(JaxGATv2Stencil(out_channels=m.spatial_out_channels, heads=m.spatial_heads).apply(
            {"params": world.params["spatial"]["gat"]}, jnp.asarray(x), world.shifts, jnp.asarray(valid)
        ))
        gat = world.port().spatial_encoder.gat_conv
        with torch.no_grad():
            got = gat(_t(x), world.shifts, _t(valid), use_kernel=use_kernel).numpy()
        _close(got[:, :n_real], want[:, :n_real])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:, n_real:], np.broadcast_to(world.flat["spatial/gat/bias"], got[:, n_real:].shape), atol=1e-6)

    @pytest.mark.parametrize("block", [0, 1])
    def test_conv_block(self, world, block):
        m = world.jm
        cin = (m.spatial_channels,) + tuple(m.temporal_channel_list)
        rng = np.random.default_rng(2 + block)
        length = m.temporal_seq_len // (2 ** block)
        x = rng.normal(size=(5, length, cin[block])).astype(np.float32)
        want = JaxConvBlock(
            out_channels=m.temporal_channel_list[block], stride=m.temporal_strides[block],
            kernel_sizes=m.conv_kernel_sizes, fuse_branches=False,
        ).apply({"params": world.params["temporal"][f"block_{block}"]}, jnp.asarray(x))
        conv = world.port().temporal_encoder.conv_embedder.embedder[block]
        with torch.no_grad():
            got = conv(_t(x).transpose(1, 2)).transpose(1, 2)
        _close(got, want)

    def test_temporal_encoder(self, world):
        m = world.jm
        x = np.random.default_rng(4).normal(size=(6, m.temporal_seq_len, m.spatial_channels)).astype(np.float32)
        want = JaxTemporal(m, fuse_branches=False).apply({"params": world.params["temporal"]}, jnp.asarray(x))
        with torch.no_grad():
            got = world.port().temporal_encoder(_t(x))
        _close(got, want)

    def test_lora_dense(self, world):
        m = world.jm
        x = np.random.default_rng(5).normal(size=(7, 3, m.d_llm)).astype(np.float32)
        want = JaxLoRADense(features=3 * m.d_llm, rank=m.lora_r, alpha=m.lora_alpha).apply(
            {"params": world.params["llm"]["h_0"]["attn"]["c_attn"]}, jnp.asarray(x)
        )
        with torch.no_grad():
            got = world.port().llm_backbone.model.h[0].attn.c_attn(_t(x))
        _close(got, want)

    @pytest.mark.parametrize("base", ["trained", "frozen"])
    @pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
    @pytest.mark.parametrize("parallel", [None, "column"], ids=["whole", "column"])
    @pytest.mark.parametrize("lead", [(11,), (5, 3)], ids=["2d", "3d"])
    @pytest.mark.parametrize("rank", [0, 32])
    def test_lora_dense_finishes_in_the_product_as_the_separate_passes_did(self, rank, lead, parallel, training, base):
        """The bias in the product's epilogue and the adapter as extra columns
        of the same product give what the separate passes gave: ``x @ W + b``,
        then ``(dropout(x) A) B`` scaled and added, with the same gradients
        from as many operations (a frozen ``W`` and bias, as under LoRA
        training, get no gradient product). A nonzero ``lora_B`` and a scale
        other than a power of two, so the adapter's term counts; in training
        both sides draw the same dropout mask from the same seed. Without a
        model group the column-parallel form differs only there."""
        d_in, d_out = 48, 72
        layer = LoRADense(d_in, d_out, rank, alpha=48.0, lora_dropout=0.25)
        layer.parallel = parallel
        g = torch.Generator().manual_seed(rank + len(lead))
        with torch.no_grad():
            for param in layer.parameters():
                param.copy_(torch.randn(param.shape, generator=g) / param.shape[-1] ** 0.5)
            layer.bias.copy_(torch.randn(d_out, generator=g))
        layer.weight.requires_grad_(base == "trained")
        layer.bias.requires_grad_(base == "trained")
        layer.train(training)
        x = torch.randn(*lead, d_in, generator=g)
        grad_out = torch.randn(*lead, d_out, generator=g)

        def separate_passes(x):
            dt = x.dtype
            y = x @ layer.weight.to(dt) + layer.bias.to(dt)
            if rank > 0:
                h = F.dropout(x, layer.lora_dropout, layer.training)
                y = y + (h @ layer.lora_A.weight.t().to(dt)) @ layer.lora_B.weight.t().to(dt) * layer.scaling
            return y

        grads, flops = [], []
        for forward in (layer, separate_passes):
            layer.zero_grad(set_to_none=True)
            xi = x.clone().requires_grad_(True)
            torch.manual_seed(7)
            with FlopCounterMode(display=False) as fc:
                y = forward(xi)
                (y * grad_out).sum().backward()
            grads.append([y, xi.grad] + [p.grad for p in layer.parameters()])
            flops.append(fc.get_total_flops())
        assert len(grads[0]) == (6 if rank else 4) and flops[0] == flops[1]
        assert (layer.weight.grad is None) == (base == "frozen")
        for got, want in zip(*grads):  # within 1e-5 of each tensor's scale: fp32 sums in another order
            if want is None:
                assert got is None
                continue
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.detach().abs().max()))
        with torch.no_grad():
            torch.manual_seed(7)
            got = layer(x.bfloat16())
            torch.manual_seed(7)
            want = separate_passes(x.bfloat16())
        assert got.dtype == torch.bfloat16 and got.shape == (*lead, d_out)
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)

    @pytest.mark.parametrize(
        "fused_attn,use_fused_mlp", [(False, False), (True, False), (False, True), (True, True)]
    )
    def test_gpt2_block(self, world, fused_attn, use_fused_mlp):
        """The kernel routes (here: the kernels' plain versions) against the
        Flax block with the same flags; on the CPU the Flax fused-MLP branch runs
        its XLA reference, which has the Pallas body's two-pass LayerNorm."""
        m = world.jm
        x = np.random.default_rng(6).normal(size=(9, 3, m.d_llm)).astype(np.float32)
        want = JaxBlock(m, lean_ln=True, fused_attn=fused_attn, use_fused_mlp=use_fused_mlp).apply(
            {"params": world.params["llm"]["h_0"]}, jnp.asarray(x), True
        )
        block = world.port(fused_attn=fused_attn, use_fused_mlp=use_fused_mlp).llm_backbone.model.h[0]
        with torch.no_grad():
            got = block(_t(x))
        _close(got, want)

    def test_gpt2_backbone(self, world):
        m = world.jm
        x = np.random.default_rng(7).normal(size=(5, 3, m.d_llm)).astype(np.float32)
        want = JaxBackbone(m, lean_ln=True).apply({"params": world.params["llm"]}, jnp.asarray(x), True)
        with torch.no_grad():
            got = world.port().llm_backbone(_t(x))
        _close(got, want)

    def test_head(self, world):
        m = world.jm
        x = np.random.default_rng(8).normal(size=(4, m.num_patches, m.d_llm)).astype(np.float32)
        want = JaxHead(m).apply({"params": world.params["head"]}, jnp.asarray(x))
        with torch.no_grad():
            got = world.port().prediction_head(_t(x))
        _close(got, want)


class TestFullForward:
    @pytest.mark.parametrize("flags", [
        {}, {"gat_kernel": False}, {"fused_attn": True, "use_fused_mlp": True},
    ], ids=["default", "plain_gat", "fused"])
    def test_matches_jax_with_node_padding(self, world, flags):
        """pad_nodes_to=32 pads the 48-node grid to 64 lanes on both sides."""
        want = world.jax_forward()
        got = world.port_forward(**flags)
        assert got.shape == want.shape == (2, world.jm.prediction_horizon, world.jm.num_nodes, 1)
        _close(got, want, atol=1e-4, rtol=1e-4)

    def test_revin_and_quantiles(self):
        w = World(seed=1, revin=True, quantiles=(0.1, 0.5, 0.9))
        want = w.jax_forward()
        got = w.port_forward()
        assert got.shape == (2, w.jm.prediction_horizon, w.jm.num_nodes, 3)
        assert (np.diff(got, axis=-1) >= 0).all()
        _close(got, want, atol=1e-4, rtol=1e-4)

    def test_no_padding_below_one_multiple(self):
        w = World(seed=2, pad_nodes_to=128)  # 48 nodes < 128: left alone on both sides
        _close(w.port_forward(), w.jax_forward(), atol=1e-4, rtol=1e-4)


class TestWeights:
    def test_state_dict_round_trips_through_the_reference_importer(self, world):
        """The port's names are the reference's: the JAX importer turns the
        port's state_dict back into the tree params_to_state_dict started from."""
        sd = {k: v.numpy() for k, v in world.port().state_dict().items()}
        back = flatten_dict(reference_state_dict_to_params(sd, world.jm), sep="/")
        assert set(back) == set(world.flat)
        for k, v in world.flat.items():
            np.testing.assert_array_equal(np.asarray(back[k]).reshape(v.shape), v, err_msg=k)

    def test_every_parameter_is_converted(self, world):
        sd = params_to_state_dict(world.flat, world.pm)
        assert set(sd) == set(world.port().state_dict())
        assert sum(v.numel() for v in sd.values()) == sum(v.size for v in world.flat.values())

    def test_seeded_init_is_reproducible(self, world):
        a = TECMoLLM(world.pm, world.shifts, seed=3).state_dict()
        b = TECMoLLM(world.pm, world.shifts, seed=3).state_dict()
        c = TECMoLLM(world.pm, world.shifts, seed=4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["llm_backbone.model.wpe.weight"], c["llm_backbone.model.wpe.weight"])
        assert not a["spatio_temporal_embedding.year_embedding.weight"].any()
        assert not a["llm_backbone.model.h.0.attn.c_attn.lora_B.weight"].any()

    def test_train_mode_runs_the_plain_paths_with_dropout(self, world):
        model = world.port(fused_attn=False, use_fused_mlp=True).train()
        _, graph = graph_inputs(world.graph, "cpu")
        torch.manual_seed(0)
        out = model(_t(world.x), _t(world.tf), *graph)
        out.sum().backward()
        assert torch.isfinite(out).all()
        assert model.llm_backbone.model.h[0].attn.c_attn.lora_A.weight.grad is not None

    def test_graph_without_stencil_is_refused(self, world):
        """A graph without a stencil is refused by a model built for the
        stencil: graph_inputs hands it the padded (N, D) table, which only a
        padded-gather model (stencil_shifts=None) takes."""
        g = dataclasses.replace(world.graph, stencil_shifts=None, stencil_valid=None)
        from tec_mollm_tpu_torch.graph import GraphData

        port_graph = GraphData(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
        shifts, (neighbors, mask) = graph_inputs(port_graph, "cpu")
        assert shifts is None and neighbors.dtype == torch.int64 and mask.dtype == torch.bool
        with pytest.raises(ValueError, match="stencil"), torch.no_grad():
            world.port()(_t(world.x), _t(world.tf), neighbors, mask)
