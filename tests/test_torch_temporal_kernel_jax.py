"""PyTorch port: the temporal conv kernel's plain mirror
(``ops/temporal_conv.py:temporal_conv_mirror``, what csrc/temporal_conv.cu
computes) against the JAX package's ``MultiScaleConvBlock`` pair at the
flagship widths (22 -> 64 -> 128, k 3/5/7, strides 2/2, 48 steps), unfused,
on the same parameters with GroupNorm affines and biases off their identity
values: fp32, within 1e-5. Inputs and parameters are numpy arrays handed to
both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ablation import _block_state_dict

from tec_mollm_tpu.models.temporal import MultiScaleConvBlock as JaxConvBlock
from tec_mollm_tpu_torch.ops.temporal_conv import pack_blocks, temporal_conv_mirror
from tec_mollm_tpu_torch.models.temporal import MultiScaleConvBlock
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = ((22, 64), (64, 128))


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_matches_the_jax_blocks(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 48, 22)).astype(np.float32)
    h, ports = jnp.asarray(x), []
    for cin, cout in WIDTHS:
        block = JaxConvBlock(out_channels=cout, stride=2, fuse_branches=False)
        params = jax.device_get(block.init(jax.random.key(seed), h)["params"])
        params = jax.tree_util.tree_map(
            lambda a: (a + 0.2 * rng.normal(size=a.shape)).astype(np.float32), params)
        h = block.apply({"params": params}, h)
        port = MultiScaleConvBlock(cin, cout, 2)
        port.load_state_dict(_block_state_dict(params, (3, 5, 7)))
        ports.append(port)
    with torch.no_grad():
        got = temporal_conv_mirror(torch.from_numpy(x), *pack_blocks(ports, torch.float32))
    assert got.shape == h.shape == (6, 12, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), atol=1e-5, rtol=1e-5)
