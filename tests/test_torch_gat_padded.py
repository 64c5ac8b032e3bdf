"""PyTorch port: the padded-gather GATv2 and the GAT kernel's routing.

The padded GATv2 and the whole model in padded-gather mode (a graph without a
stencil) against the Flax ones, with parameters redrawn from a numpy seed and
numpy inputs; the port's two modes against each other on a grid; one train
step in padded mode against JAX's; and the route the model takes to the stencil
kernel, which is settled from the config and the stencil before any launch.
Tolerances: the GAT layer fp32 1e-5 and bf16 2e-2, the model 1e-4 (as
tests/test_torch_models.py), the train step's loss 1e-5 relative and its
update 2e-6 per parameter (as tests/test_torch_training.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.synthetic import grid_coordinates
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.models import TECMoLLM as JaxTECMoLLM
from tec_mollm_tpu.models.gat import GATv2 as JaxGATv2
from tec_mollm_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from tec_mollm_tpu.training.optimizer import trainable_mask as jax_trainable_mask
from tec_mollm_tpu.training.train_state import TrainState as JaxTrainState
from tec_mollm_tpu.training.train_state import make_train_step as jax_make_train_step
from tec_mollm_tpu.training.train_state import partition_params
from tec_mollm_tpu_torch.graph import GraphData
from tec_mollm_tpu_torch.graph import build_graph as port_build_graph
from tec_mollm_tpu_torch.graph import grid_coordinates as port_grid_coordinates
from tec_mollm_tpu_torch.graph.builder import build_grid_stencil
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs, params_to_state_dict
from tec_mollm_tpu_torch.models.gat import GATv2, GATv2Stencil
from tec_mollm_tpu_torch.models.tec_mollm import opt_in_kernel_refusal
from tec_mollm_tpu_torch.ops.gat_stencil import MAX_OFFSETS, MAX_SHIFT, tiled_takes
from tec_mollm_tpu_torch.training import create_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAD = 32
NO_DROPOUT = dict(gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0)


def _redraw(flat, seed, std=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("/scale"):
            out[k] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("/embedding"):
            out[k] = rng.normal(size=v.shape).astype(np.float32)
        else:
            out[k] = (std * rng.normal(size=v.shape)).astype(np.float32)
    return out


def _port_graph(graph, stencil: bool = True) -> GraphData:
    """The JAX package's graph as the port's GraphData, with or without its stencil."""
    fields = {f.name: getattr(graph, f.name) for f in dataclasses.fields(graph)}
    if not stencil:
        fields.update(stencil_shifts=None, stencil_valid=None)
    return GraphData(**fields)


def _inputs(m, batch=2, seed=100):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, m.temporal_seq_len, m.num_nodes, m.in_features)).astype(np.float32)
    tf = np.stack([
        rng.integers(0, m.num_tod, size=(batch, m.temporal_seq_len)),
        rng.integers(0, m.num_doy, size=(batch, m.temporal_seq_len)),
        rng.integers(0, m.num_years, size=(batch, m.temporal_seq_len)),
        rng.integers(0, m.num_seasons, size=(batch, m.temporal_seq_len)),
    ], axis=-1).astype(np.int32)
    return x, tf


class PaddedWorld:
    """A tiny JAX model in padded-gather mode with redrawn parameters, every
    dropout 0 (the forward tests run deterministic; the train step compares
    no dropout bits), lr 1e-3 and one batch of 4."""

    def __init__(self, seed=0):
        self.jc, self.pc = (
            dataclasses.replace(
                c,
                model=dataclasses.replace(c.model, **NO_DROPOUT),
                train=dataclasses.replace(c.train, lr=1e-3, batch_size=4, accumulation_steps=1),
            )
            for c in (jcfg.tiny_config(), pcfg.tiny_config())
        )
        m = self.jc.model
        self.graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
        self.shifts = tuple(int(s) for s in self.graph.stencil_shifts)
        self.x, self.tf = _inputs(m, seed=100 + seed)
        self.jmodel = JaxTECMoLLM(m, stencil_shifts=None, pad_nodes_to=PAD)
        self.nbr, self.mask = np.asarray(self.graph.neighbors), np.asarray(self.graph.neighbor_mask)
        init = jax.jit(self.jmodel.init)(
            jax.random.key(seed), jnp.asarray(self.x), jnp.asarray(self.tf), jnp.asarray(self.nbr), jnp.asarray(self.mask)
        )["params"]
        self.flat = _redraw(flatten_dict(jax.device_get(init), sep="/"), seed)

    def port(self, stencil: bool, **kwargs) -> tuple[TECMoLLM, tuple]:
        shifts, graph = graph_inputs(_port_graph(self.graph, stencil), "cpu")
        model = TECMoLLM(self.pc.model, shifts, pad_nodes_to=PAD, **kwargs)
        model.load_state_dict(params_to_state_dict(self.flat, self.pc.model))
        return model.eval(), graph

    def port_forward(self, stencil: bool) -> np.ndarray:
        model, graph = self.port(stencil)
        with torch.no_grad():
            return model(torch.from_numpy(self.x), torch.from_numpy(self.tf), *graph).numpy()


@pytest.fixture(scope="module")
def world():
    return PaddedWorld()


class TestGATv2:
    @pytest.mark.parametrize("dtype, atol", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)], ids=["fp32", "bf16"])
    def test_matches_flax(self, world, dtype, atol):
        m = world.jc.model
        x = np.random.default_rng(1).normal(size=(3, 2, m.num_nodes, m.spatial_in_channels)).astype(np.float32)
        params = unflatten_dict(world.flat, sep="/")["spatial"]["gat"]
        want = JaxGATv2(out_channels=m.spatial_out_channels, heads=m.spatial_heads, dtype=dtype).apply(
            {"params": params}, jnp.asarray(x, dtype), jnp.asarray(world.nbr), jnp.asarray(world.mask)
        )
        model, (nbr, mask) = world.port(stencil=False, dtype=torch.float32)
        gat = model.spatial_encoder.gat_conv
        assert isinstance(gat, GATv2)
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        with torch.no_grad():
            got = gat(torch.from_numpy(x).to(tdt), nbr, mask)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=atol)

    def test_padded_and_stencil_modes_agree_on_the_grid(self, world):
        """One state_dict in both modes: the GAT layers and whole forwards."""
        m = world.pc.model
        padded, pg = world.port(stencil=False)
        stencil, sg = world.port(stencil=True)
        assert isinstance(stencil.spatial_encoder.gat_conv, GATv2Stencil)
        x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, m.num_nodes, m.spatial_in_channels)).astype(np.float32))
        with torch.no_grad():
            a = padded.spatial_encoder(x, *pg)
            b = stencil.spatial_encoder(x, *sg)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(world.port_forward(False), world.port_forward(True), atol=1e-5, rtol=1e-5)

    def test_padded_lanes_give_the_bias(self, world):
        """pad_nodes_to's lanes have no valid neighbour: zero attention, the bias
        alone, finite (the table row points at node 0, masked)."""
        m = world.pc.model
        model, (nbr, mask) = world.port(stencil=False)
        gat = model.spatial_encoder.gat_conv
        n = m.num_nodes
        nbr_p = torch.nn.functional.pad(nbr, (0, 0, 0, 16))
        mask_p = torch.nn.functional.pad(mask, (0, 0, 0, 16))
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, n + 16, m.spatial_in_channels)).astype(np.float32))
        with torch.no_grad():
            out = gat(x, nbr_p, mask_p)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[:, n:], gat.bias.expand(2, 16, -1), rtol=0, atol=1e-6)


class TestPaddedModel:
    def test_matches_jax_in_padded_mode(self, world):
        want = np.asarray(jax.jit(world.jmodel.apply)(
            {"params": unflatten_dict(world.flat, sep="/")}, jnp.asarray(world.x), jnp.asarray(world.tf),
            jnp.asarray(world.nbr), jnp.asarray(world.mask),
        ))
        got = world.port_forward(stencil=False)
        assert got.shape == want.shape == (2, world.jc.model.prediction_horizon, world.jc.model.num_nodes, 1)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_one_train_step_matches_jax(self, world):
        """Every dropout 0, fp32: loss within 1e-5 relative and each updated
        parameter within 2e-6 of the JAX step's (lr 1e-3)."""
        jc, pc, m = world.jc, world.pc, world.jc.model
        x, tf = _inputs(m, batch=4, seed=5)
        y = np.random.default_rng(6).normal(size=(4, m.num_nodes, m.prediction_horizon)).astype(np.float32)
        batch = {"x": x, "time_features": tf, "y": y}
        params = unflatten_dict(world.flat, sep="/")
        trainable, frozen = partition_params(params, jax_trainable_mask(params))
        tx = jax_build_optimizer(jc.train)
        jstate = JaxTrainState(
            step=jnp.zeros((), jnp.int32), trainable=trainable, frozen=frozen, opt_state=tx.init(trainable),
            rng=jax.random.key(0),
        )
        jstate, jmetrics = jax.jit(jax_make_train_step(world.jmodel, jc, tx))(
            jstate, jax.tree.map(jnp.asarray, batch), (jnp.asarray(world.nbr), jnp.asarray(world.mask))
        )

        model, pgraph = world.port(stencil=False)
        pstate, mask = create_train_state(model, pc, seed=0)
        _, metrics = make_train_step(model, pc)(pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, pgraph)
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)

        jflat = flatten_dict(jax.device_get(jstate.params), sep="/")
        want = params_to_state_dict({k: np.asarray(v) for k, v in jflat.items()}, pc.model)
        before = params_to_state_dict(world.flat, pc.model)
        trained = {n: p.detach().numpy() for n, p in model.named_parameters() if mask[n]}
        assert sum(not np.array_equal(p, before[n].numpy()) for n, p in trained.items()) > len(trained) // 2
        diffs = {n: np.abs(p - want[n].numpy()) for n, p in trained.items()}
        outliers = sum(int((d > 2e-6).sum()) for d in diffs.values())
        assert outliers <= 1e-4 * sum(d.size for d in diffs.values()), outliers
        assert max(float(d.max()) for d in diffs.values()) <= 2e-3


def _numpy_rule(shifts, heads, channels) -> bool:
    """What the tiled kernel takes: at most 64 offsets, |shift| <= 144, 2 x 11."""
    return 1 <= len(shifts) <= MAX_OFFSETS and max(abs(int(s)) for s in shifts) <= MAX_SHIFT and (heads, channels) == (2, 11)


class TestKernelRouting:
    @pytest.mark.parametrize("seed", range(3))
    def test_predicate_matches_numpy(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(60):
            shifts = rng.integers(-MAX_SHIFT - 8, MAX_SHIFT + 9, size=int(rng.integers(1, MAX_OFFSETS + 8)))
            heads, channels = [(2, 11), (1, 22), (2, 7), (11, 2)][int(rng.integers(0, 4))]
            reason = tiled_takes(shifts, heads, channels)
            assert (reason is None) == _numpy_rule(shifts, heads, channels), (shifts, heads, channels)
            assert reason is None or "tiled kernel" in reason

    @pytest.mark.parametrize("km", [150.0, 300.0])
    def test_flagship_config_takes_the_kernel(self, km):
        cfg = pcfg.Config().resolved().model
        shifts, _ = build_grid_stencil(*port_grid_coordinates(41, 71), km)
        assert tiled_takes(shifts, cfg.spatial_heads, cfg.spatial_out_channels) is None
        model = TECMoLLM(pcfg.tiny_config().model, tuple(int(s) for s in shifts))
        assert model.gat_kernel and model.gat_route == "kernel"

    @pytest.mark.parametrize("model_over, shifts, reason", [
        (dict(spatial_heads=1, spatial_out_channels=22), None, "2 heads x 11 channels, got 1x22"),
        (dict(spatial_heads=2, spatial_out_channels=7, d_emb=8), None, "got 2x7"),
        ({}, (0, 1, MAX_SHIFT + 1), f"shifts up to {MAX_SHIFT}"),
        ({}, tuple(range(MAX_OFFSETS + 1)), f"1 to {MAX_OFFSETS} offsets"),
    ], ids=["1x22", "2x7", "shift_past_144", "65_offsets"])
    def test_other_shapes_take_the_general_kernel(self, model_over, shifts, reason):
        """Configs the JAX package accepts and the tiled kernel does not take
        still go to the kernel, in its general form, with the reason in the
        route; on the CPU they forecast as the plain route does."""
        cfg = pcfg.tiny_config()
        m = dataclasses.replace(cfg.model, **model_over)
        graph = port_build_graph(*port_grid_coordinates(m.grid_h, m.grid_w))
        grid_shifts, (valid, _) = graph_inputs(graph, "cpu")
        shifts = grid_shifts if shifts is None else shifts
        if len(shifts) != len(grid_shifts):
            valid = torch.zeros(len(shifts), m.num_nodes, dtype=torch.bool)
            valid[0] = True
        model = TECMoLLM(m, shifts, seed=1)
        assert model.gat_kernel
        assert model.gat_route.startswith("kernel, general form: ") and reason in model.gat_route
        plain = TECMoLLM(m, shifts, gat_kernel=False)
        plain.load_state_dict(model.state_dict())
        x, tf = _inputs(m, batch=1)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x), torch.from_numpy(tf), valid)
            want = plain.eval()(torch.from_numpy(x), torch.from_numpy(tf), valid)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_padded_graph_and_switch_routes(self, world):
        assert world.port(stencil=False)[0].gat_route == "plain: padded-gather graph (no stencil)"
        assert world.port(stencil=True, gat_kernel=False)[0].gat_route == "plain: gat_kernel=False"


class TestOptInRefusals:
    """The opt-in kernels' limits, refused on the card before weights load
    (the predicate: no card here)."""

    @pytest.mark.parametrize("over, dtype, fused_attn, use_fused_mlp, match", [
        ({}, torch.bfloat16, True, True, None),
        ({}, torch.float32, False, True, "bf16"),
        (dict(d_llm=2048, llm_heads=32), torch.bfloat16, False, True, "1536"),
        (dict(llm_heads=6), torch.bfloat16, True, False, "head dim of 32 or 64 on the card, got 768/6 = 128"),
        (dict(llm_heads=6), torch.float32, False, False, None),
    ], ids=["flagship", "mlp_fp32", "mlp_wide", "attn_hd128", "nothing_asked"])
    def test_predicate(self, over, dtype, fused_attn, use_fused_mlp, match):
        m = dataclasses.replace(pcfg.Config().model, **over)
        reason = opt_in_kernel_refusal(m, dtype, fused_attn, use_fused_mlp)
        assert (reason is None) == (match is None)
        assert match is None or match in reason
