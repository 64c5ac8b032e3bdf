"""PyTorch port: the training step against the JAX package's.

One tiny model (``tiny_config(L_in=48)``, so the GPT-2 blocks see T = 3 tokens,
with the 48-node grid padded to 64 lanes) starts from the same redrawn
parameters on both sides. Every dropout rate is 0, because the two frameworks
draw different bits. The port runs its training path, the short-attention
function included (its plain forward and backward on the CPU); the JAX model
runs its unrolled attention, which in fp32 is the same arithmetic. All fp32.
Tolerances: losses and norms to 1e-5 relative (fp32 sums in another order);
parameters after AdamW to 2e-6 absolute per update at lr 1e-3 (an update is
about lr in size, so that is 0.2% of one). Adam divides each gradient by its
own magnitude (plus eps 1e-8), so where a gradient is at fp32 noise level
(|g| ~ 1e-8) the two sides may step differently; an update is at most lr in
size, so those elements, at most 1 in 10^4, are held to 2 * lr per update."""

import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.dataset import SlidingWindowDataset
from tec_mollm_tpu.data.synthetic import grid_coordinates, synthetic_processed_split
from tec_mollm_tpu.graph import build_graph
from tec_mollm_tpu.models import TECMoLLM as JaxTECMoLLM
from tec_mollm_tpu.training import loss as jloss
from tec_mollm_tpu.training.optimizer import trainable_mask as jax_trainable_mask
from tec_mollm_tpu.training.schedule import cosine_annealing_warm_restarts as jax_schedule
from tec_mollm_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)
from tec_mollm_tpu.training.train_state import make_sum_loss_fn as jax_sum_loss_fn
from tec_mollm_tpu.training.train_state import make_train_step as jax_make_train_step
from tec_mollm_tpu.training.train_state import partition_params
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs, params_to_state_dict
from tec_mollm_tpu_torch.training import (
    create_train_state,
    cosine_annealing_warm_restarts,
    make_eval_step,
    make_sum_loss_fn,
    make_train_step,
    trainable_mask,
)
from tec_mollm_tpu_torch.training import loss as ploss
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
LR, PAD = 1e-3, 32
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
NO_DROPOUT = dict(gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0)


def _configs(accum=1, batch=4, ema=0.0, **model):
    out = []
    for mod in (jcfg, pcfg):
        c = mod.tiny_config(L_in=48)
        c = dataclasses.replace(
            c,
            model=dataclasses.replace(c.model, **{**NO_DROPOUT, **model}),
            train=dataclasses.replace(c.train, lr=LR, batch_size=batch // accum, accumulation_steps=accum, ema_decay=ema),
        )
        out.append(c)
    return out


def _redraw(flat, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith("/scale"):
            out[k] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("/embedding"):
            out[k] = rng.normal(size=v.shape).astype(np.float32)
        else:
            out[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return out


class Setup:
    """The same tiny model, parameters and batch on both sides."""

    def __init__(self, accum=1, batch=4, ema=0.0, **model):
        self.jc, self.pc = _configs(accum, batch, ema, **model)
        m = self.jc.model
        self.graph = build_graph(*grid_coordinates(m.grid_h, m.grid_w))
        self.shifts = tuple(int(s) for s in self.graph.stencil_shifts)
        valid = jnp.asarray(self.graph.stencil_valid)
        self.jgraph = (valid, valid)
        split = synthetic_processed_split(num_windows=12, L_in=48, L_out=m.prediction_horizon, num_nodes=m.num_nodes, seed=0)
        self.ds = SlidingWindowDataset(split, 48, m.prediction_horizon)
        self.batch = self.ds.gather_batch(np.arange(batch))
        self.jmodel = JaxTECMoLLM(m, stencil_shifts=self.shifts, pad_nodes_to=PAD)
        state, self.tx, self.jmask = jax_create_train_state(
            self.jmodel, self.jc, jax.random.key(0), self.batch, self.jgraph
        )
        self.flat = _redraw(flatten_dict(jax.device_get(state.params), sep="/"))
        trainable, frozen = partition_params(unflatten_dict(self.flat, sep="/"), self.jmask)
        self.jstate = state.replace(
            trainable=trainable, frozen=frozen, opt_state=self.tx.init(trainable),
            ema=jax.tree.map(jnp.copy, trainable) if ema > 0 else None,
        )

    def port(self, frozen_dtype=None, **kwargs):
        model = TECMoLLM(self.pc.model, self.shifts, pad_nodes_to=PAD, fused_attn=True, **kwargs)
        model.load_state_dict(params_to_state_dict(self.flat, self.pc.model))
        state, mask = create_train_state(model, self.pc, seed=0, frozen_dtype=frozen_dtype)
        _, graph = graph_inputs(self.graph, "cpu")
        return model, state, mask, graph

    def tensors(self, batch=None):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in (batch or self.batch).items()}

    def jax_steps(self, n, batch=None):
        step = jax.jit(jax_make_train_step(self.jmodel, self.jc, self.tx))
        b = jax.tree.map(jnp.asarray, batch or self.batch)
        s, out = self.jstate, []
        for _ in range(n):
            s, metrics = step(s, b, self.jgraph)
            out.append((s, {k: float(v) for k, v in metrics.items()}))
        return out

    def to_port_names(self, tree):
        """A JAX (sub)tree with None for frozen leaves -> {port name: ndarray}."""
        flat = flatten_dict(jax.device_get(tree), sep="/")
        full = {k: (np.zeros_like(v) if flat.get(k) is None else np.array(flat[k])) for k, v in self.flat.items()}
        return {k: v.numpy() for k, v in params_to_state_dict(full, self.pc.model).items()}


@pytest.fixture(scope="module")
def one():
    """accumulation 1, EMA 0.9: the JAX trajectory over 3 updates."""
    s = Setup(ema=0.9)
    s.jax_traj = s.jax_steps(3)
    return s


def _port_steps(setup, n, batch=None, **kwargs):
    model, state, mask, valid = setup.port(**kwargs)
    step = make_train_step(model, setup.pc)
    b = setup.tensors(batch)
    metrics = []
    for _ in range(n):
        state, m = step(state, b, valid)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state, mask, metrics


def _trainable(model, mask):
    sd = model.state_dict()
    return {name: sd[name].float().numpy() for name, t in mask.items() if t}


def _assert_params(got, want, updates=1):
    """Every tensor of ``got`` within PARAM_ATOL per update of ``want``, except
    at most 1 element in 10^4, which is within 2 * LR per update (see the
    module docstring)."""
    diffs = {name: np.abs(g - want[name]) for name, g in got.items()}
    outliers = sum(int((d > updates * PARAM_ATOL).sum()) for d in diffs.values())
    assert outliers <= 1e-4 * sum(d.size for d in diffs.values()), outliers
    for name, d in diffs.items():
        assert d.max() <= 2 * LR * updates, (name, d.max())


class TestBuildingBlocks:
    def test_losses(self):
        rng = np.random.default_rng(0)
        p, y = rng.normal(size=(3, 4, 5, 3)).astype(np.float32) * 2, rng.normal(size=(3, 4, 5, 1)).astype(np.float32)
        w = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None, None]
        tp, ty, tw = (torch.from_numpy(a) for a in (p, y, w))
        q = (0.1, 0.5, 0.9)
        pairs = [
            (ploss.huber_loss(tp, ty, 1.0), jloss.huber_loss(p, y, 1.0)),
            (ploss.huber_loss(tp, ty, 0.5, weights=tw), jloss.huber_loss(p, y, 0.5, weights=w)),
            (ploss.pinball_loss(tp, ty, q), jloss.pinball_loss(p, y, q)),
            (ploss.pinball_loss(tp, ty, q, weights=tw), jloss.pinball_loss(p, y, q, weights=w)),
            (ploss.huber_elementwise(tp, ty).sum(), jnp.sum(jloss.huber_elementwise(p, y))),
        ]
        for got, want in pairs:
            assert float(got) == pytest.approx(float(want), rel=1e-6)

    @pytest.mark.parametrize("t_mult", [1, 2, 3])
    def test_schedule_matches_jax_over_200_updates(self, t_mult):
        ours = cosine_annealing_warm_restarts(1e-4, 10, t_mult, 1e-7)
        theirs = jax_schedule(1e-4, 10, t_mult, 1e-7)
        got = [ours(s) for s in range(201)]
        want = [float(theirs(jnp.asarray(s))) for s in range(201)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)
        if t_mult == 2:  # restarts land on their step: 10, 30, 70, 150
            assert [s for s in range(1, 201) if got[s] > got[s - 1]] == [10, 30, 70, 150]

    def test_trainable_set_equals_jax_mask(self, one):
        jmask = flatten_dict(jax_trainable_mask(unflatten_dict(one.flat, sep="/")), sep="/")
        per_name = params_to_state_dict({k: np.full(one.flat[k].shape, float(v)) for k, v in jmask.items()}, one.pc.model)
        _, _, mask, _ = one.port()
        assert set(mask) == set(per_name)
        for name, arr in per_name.items():
            assert arr.min() == arr.max() == float(mask[name]), name
        assert mask["llm_backbone.model.h.0.attn.c_attn.lora_A.weight"]
        assert not mask["llm_backbone.model.h.0.attn.c_attn.weight"]


class TestTrainStep:
    def test_one_step_loss_clipped_grads_and_params(self, one):
        """Loss, pre-clip norm, the clipped mean gradients (the JAX ones from
        its sum-loss function, divided by the count and clipped by optax) and
        the updated parameters."""
        model, state, mask, metrics = _port_steps(one, 1)
        _, jmetrics = one.jax_traj[0]
        assert metrics[0]["loss"] == pytest.approx(jmetrics["loss"], rel=LOSS_RTOL)
        assert metrics[0]["grad_norm"] == pytest.approx(jmetrics["grad_norm"], rel=1e-4)
        assert jmetrics["grad_norm"] > one.jc.train.clip_grad_norm  # the clip is active

        loss_fn = jax_sum_loss_fn(one.jmodel, one.jc)
        (_, count), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            one.jstate.trainable, one.jstate.frozen, jax.tree.map(jnp.asarray, one.batch), one.jgraph, jax.random.key(1)
        )
        g = jax.tree.map(lambda a: a / count, g)
        clip = optax.clip_by_global_norm(one.jc.train.clip_grad_norm)
        want = one.to_port_names(clip.update(g, clip.init(g))[0])
        for name, p in model.named_parameters():
            if mask[name]:
                np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-7, rtol=1e-4, err_msg=name)
            else:
                assert p.grad is None
        _assert_params(_trainable(model, mask), one.to_port_names(one.jax_traj[0][0].params))

    def test_three_update_trajectory_and_ema(self, one):
        model, state, mask, metrics = _port_steps(one, 3)
        for got, (_, want) in zip(metrics, one.jax_traj):
            assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
        assert metrics[-1]["loss"] < metrics[0]["loss"]
        jstate = one.jax_traj[-1][0]
        _assert_params(_trainable(model, mask), one.to_port_names(jstate.params), updates=3)
        assert state.step == int(jstate.step) == 3
        _assert_params({n: e.numpy() for n, e in state.ema.items()}, one.to_port_names(jstate.ema), updates=3)
        assert any(not torch.equal(state.ema[n], p) for n, p in state.trainable().items())

    def test_accumulation_matches_one_batch_and_jax(self):
        """2 microbatches of 2 give the macro batch of 4's step, and the JAX
        step at accumulation 2."""
        two = Setup(accum=2)
        jstate, jmetrics = two.jax_steps(1)[0]
        model2, _, mask, m2 = _port_steps(two, 1)
        one = Setup(accum=1)
        model1, _, _, m1 = _port_steps(one, 1)
        assert m2[0]["loss"] == pytest.approx(m1[0]["loss"], rel=LOSS_RTOL)
        assert m2[0]["loss"] == pytest.approx(jmetrics["loss"], rel=LOSS_RTOL)
        assert m2[0]["grad_norm"] == pytest.approx(jmetrics["grad_norm"], rel=1e-4)
        _assert_params(_trainable(model2, mask), _trainable(model1, mask))
        _assert_params(_trainable(model2, mask), two.to_port_names(jstate.params))

    def test_valid_rows_carry_zero_weight(self, one):
        """Rows with valid=False change neither the loss nor the gradients: the
        step on [a, b, pad, pad] is the step on [a, b]."""
        padded = dict(one.ds.gather_batch(np.array([0, 1, 5, 6])), valid=np.array([True, True, False, False]))
        clean = one.ds.gather_batch(np.array([0, 1]))
        model_p, _, mask, mp = _port_steps(one, 1, batch=padded)
        model_c, _, _, mc = _port_steps(one, 1, batch=clean)
        assert mp[0]["loss"] == pytest.approx(mc[0]["loss"], rel=LOSS_RTOL)
        assert mp[0]["grad_norm"] == pytest.approx(mc[0]["grad_norm"], rel=1e-4)
        _assert_params(_trainable(model_p, mask), _trainable(model_c, mask))
        # and the weighted sum and count are JAX's
        model, _, _, valid = one.port()
        wsum, count = make_sum_loss_fn(model, one.pc)(one.tensors(padded), valid)
        jsum, jcount = jax.jit(jax_sum_loss_fn(one.jmodel, one.jc))(
            one.jstate.trainable, one.jstate.frozen, jax.tree.map(jnp.asarray, padded), one.jgraph, jax.random.key(1)
        )
        assert float(count) == float(jcount) == 2 * one.jc.model.prediction_horizon * one.jc.model.num_nodes
        assert float(wsum.detach()) == pytest.approx(float(jsum), rel=LOSS_RTOL)

    def test_frozen_bf16_tensors_are_unchanged_and_without_gradients(self, one):
        model, state, mask, valid = one.port(frozen_dtype=torch.bfloat16)
        frozen = {n: p.clone() for n, p in state.frozen().items()}
        assert frozen and all(p.dtype == torch.bfloat16 and not p.requires_grad for p in state.frozen().values())
        assert all(p.dtype == torch.float32 for p in state.trainable().values())
        step = make_train_step(model, one.pc)
        before = {n: p.clone() for n, p in state.trainable().items()}
        for _ in range(2):
            state, m = step(state, one.tensors(), valid)
            assert np.isfinite(float(m["loss"]))
        for n, p in state.frozen().items():
            assert torch.equal(p, frozen[n]) and p.grad is None, n
        assert all(not torch.equal(p, before[n]) for n, p in state.trainable().items() if "wpe" not in n)

    def test_eval_step_masks_padding_without_gradients(self, one):
        model, _, _, valid = one.port()
        eval_step = make_eval_step(model, one.pc)
        padded = dict(one.ds.gather_batch(np.array([0, 1, 5, 6])), valid=np.array([True, True, False, False]))
        loss_p, preds, targets = eval_step(one.tensors(padded), valid)
        loss_c, _, _ = eval_step(one.tensors(one.ds.gather_batch(np.array([0, 1]))), valid)
        assert not model.training and not preds.requires_grad
        assert preds.shape == targets.shape == (4, one.pc.model.prediction_horizon, one.pc.model.num_nodes, 1)
        assert float(loss_p) == pytest.approx(float(loss_c), rel=1e-6)


class TestDropoutSeeding:
    def test_step_rerun_from_the_same_state_gives_the_same_loss(self):
        """Every dropout at its default 0.1: the step derives its generators'
        seeds from (state seed, step), so a copy of the state repeats the step."""
        s = Setup(**{k: 0.1 for k in NO_DROPOUT})
        model, state, _, valid = s.port()
        twin = copy.deepcopy(state)
        b = s.tensors()
        _, ma = make_train_step(model, s.pc)(state, b, valid)
        _, mb = make_train_step(twin.model, s.pc)(twin, b, valid)
        assert float(ma["loss"]) == float(mb["loss"])
        for (n, p), q in zip(state.trainable().items(), twin.trainable().values()):
            assert torch.equal(p, q), n
        # the next step draws other masks: a third copy stepped at step 1 differs from step 0
        _, mc = make_train_step(twin.model, s.pc)(twin, b, valid)
        assert float(mc["loss"]) != float(ma["loss"])


def test_bench_cli_quick_cpu_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "tec_mollm_tpu_torch.bench", "--quick", "--cpu", "--fused-attn"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "train_windows_per_sec_per_chip" and rec["unit"] == "windows/s/chip"
    assert rec["value"] > 0 and rec["device"] == "cpu"
