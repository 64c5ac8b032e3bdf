"""PyTorch port: the ablation arms against the JAX package's, on the CPU.

* Each conv-block path (``fuse_branches``, ``im2col``, ``lean_gn``) against
  JAX's ``MultiScaleConvBlock`` with the same path on the same parameters,
  which are the unfused block's (each arm loads its state_dict): fp32, within
  1e-5. ``lean_gn`` also at a stride that does not divide the length
  (tests/test_modules.py's case: output length ceil(L / stride)).
* ``TECMoLLM`` with ``fuse_conv``, ``lean_gn``, ``im2col_conv`` and
  ``lean_ln=False`` against the JAX model with the same field, on the same
  parameters (tests/test_torch_models.py's redrawn tiny model): within 1e-4.
* The remat policies: a train-mode loss's gradients under ``full``,
  ``nothing_saveable`` and ``dots_saveable`` (saved matrix products, the
  rest recomputed, the short-attention op too) against no remat, within 1e-6.
* The bench's new flags under ``--quick --cpu``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import World

from tec_mollm_tpu.models import TECMoLLM as JaxTECMoLLM
from tec_mollm_tpu.models.temporal import MultiScaleConvBlock as JaxConvBlock
from tec_mollm_tpu_torch import bench
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs, params_to_state_dict
from tec_mollm_tpu_torch.models.temporal import MultiScaleConvBlock
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARMS = {"fuse_branches": {"fuse_branches": True}, "im2col": {"im2col": True}, "lean_gn": {"lean_gn": True}}
MODEL_ARMS = {"fuse_conv": {"fuse_conv": True}, "lean_gn": {"lean_gn": True}, "im2col_conv": {"im2col_conv": True},
              "two_pass_ln": {"lean_ln": False}}


@pytest.fixture(scope="module")
def world():
    return World(seed=5)


def _block_state_dict(params: dict, kernel_sizes) -> dict[str, torch.Tensor]:
    """A Flax conv block's parameters in the port block's names and layouts."""
    def t(a, kernel=False):
        a = np.asarray(a)
        return torch.tensor(a.transpose(2, 1, 0) if kernel else a)  # Flax (k, in, out) -> torch (out, in, k)

    sd = {}
    for j, k in enumerate(kernel_sizes):
        conv, norm = params[f"conv_k{k}"], params[f"norm_k{k}"]
        sd[f"convs.{j}.0.weight"], sd[f"convs.{j}.0.bias"] = t(conv["kernel"], True), t(conv["bias"])
        sd[f"convs.{j}.1.weight"], sd[f"convs.{j}.1.bias"] = t(norm["scale"]), t(norm["bias"])
    sd["final_conv.weight"], sd["final_conv.bias"] = t(params["final_conv"]["kernel"], True), t(params["final_conv"]["bias"])
    return sd


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("arm", list(ARMS))
def test_conv_arm_matches_jax(world, arm, block):
    """The port block with the arm, loading the unfused block's state_dict,
    against the JAX block with the same arm on the same parameters."""
    m = world.jm
    cin = ((m.spatial_channels,) + tuple(m.temporal_channel_list))[block]
    length = m.temporal_seq_len // (2 ** block)
    x = np.random.default_rng(20 + block).normal(size=(5, length, cin)).astype(np.float32)
    params = world.params["temporal"][f"block_{block}"]
    jax_arm = {"fuse_branches": False, **ARMS[arm]}
    want = JaxConvBlock(out_channels=m.temporal_channel_list[block], stride=m.temporal_strides[block],
                        kernel_sizes=m.conv_kernel_sizes, **jax_arm).apply({"params": params}, jnp.asarray(x))
    unfused = world.port().temporal_encoder.conv_embedder.embedder[block]
    port = MultiScaleConvBlock(cin, m.temporal_channel_list[block], m.temporal_strides[block], m.conv_kernel_sizes,
                               **ARMS[arm])
    port.load_state_dict(unfused.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
        plain = unfused(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arm", list(ARMS))
def test_conv_arm_at_an_odd_stride_and_length(arm):
    """Stride 4 over 15 steps (output length 4), 5 -> 6 channels, the JAX
    block's own parameters."""
    x = np.random.default_rng(8).normal(size=(2, 15, 5)).astype(np.float32)
    plain = JaxConvBlock(out_channels=6, stride=4, fuse_branches=False)
    params = plain.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = JaxConvBlock(out_channels=6, stride=4, **{"fuse_branches": False, **ARMS[arm]}).apply(
        {"params": params}, jnp.asarray(x))
    port = MultiScaleConvBlock(5, 6, 4, **ARMS[arm])
    port.load_state_dict(_block_state_dict(params, (3, 5, 7)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == (2, 4, 6)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arm", list(MODEL_ARMS))
def test_model_arm_matches_jax(world, arm):
    """The whole forward with the arm on the unfused model's state_dict."""
    kw = MODEL_ARMS[arm]
    jax_model = JaxTECMoLLM(world.jm, stencil_shifts=world.shifts, pad_nodes_to=world.pad_nodes_to, **kw)
    want = np.asarray(jax_model.apply(
        {"params": world.params}, jnp.asarray(world.x), jnp.asarray(world.tf),
        jnp.asarray(world.valid), jnp.asarray(world.valid), deterministic=True,
    ))
    got = world.port_forward(**kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _grads(world, **kw) -> tuple[float, dict[str, torch.Tensor]]:
    """A train-mode loss (every dropout 0) and its gradients."""
    pm = dataclasses.replace(world.pm, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0,
                             post_llm_dropout=0.0)
    model = TECMoLLM(pm, world.shifts, pad_nodes_to=world.pad_nodes_to, **kw)
    model.load_state_dict(params_to_state_dict(world.flat, pm))
    model.train()
    _, graph = graph_inputs(world.graph, "cpu")
    out = model(torch.from_numpy(world.x), torch.from_numpy(world.tf), *graph)
    loss = out.square().mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("fused_attn", [False, True])
@pytest.mark.parametrize("policy", ["full", "nothing_saveable", "dots_saveable"])
def test_remat_policy_keeps_the_gradients(world, policy, fused_attn):
    loss0, want = _grads(world, fused_attn=fused_attn)
    loss, got = _grads(world, fused_attn=fused_attn, remat_llm=True, remat_policy=policy)
    assert loss == loss0
    assert set(got) == set(want) and any("lora_B" in n for n in got)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=1e-6, rtol=1e-6, err_msg=n)


def test_unknown_remat_policy_is_refused(world):
    with pytest.raises(ValueError, match="unknown remat_policy 'dots'"):
        TECMoLLM(world.pm, world.shifts, remat_llm=True, remat_policy="dots")
    TECMoLLM(world.pm, world.shifts, remat_policy="dots")  # as in JAX, read only with remat on


@pytest.mark.parametrize("flags, want", [
    (["--remat-policy", "dots_saveable", "--fuse-conv", "--two-pass-ln"],
     {"remat_llm": True, "remat_policy": "dots_saveable", "fuse_conv": True, "lean_ln": False}),
    (["--remat-policy", "full", "--no-remat"], {"remat_llm": False, "fuse_conv": False, "lean_ln": True}),
])
def test_bench_ablation_flags(flags, want, monkeypatch, capsys):
    """The JAX bench's flags: remat on with a policy unless --no-remat, the
    fused conv and the two-pass LayerNorm reach the model."""
    built = []

    class Spy(TECMoLLM):
        def __init__(self, *args, **kwargs):
            built.append(kwargs)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(bench, "TECMoLLM", Spy)
    assert bench.main(["--quick", "--cpu", *flags]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["unit"] == "windows/s/chip" and line["value"] > 0
    (kwargs,) = built
    assert {k: kwargs[k] for k in want} == want
