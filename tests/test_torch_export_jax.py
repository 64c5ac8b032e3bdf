"""PyTorch port: the exported artifact against the JAX package's StableHLO
artifact of the same weights.

JAX ``export_forecaster(..., platforms=("cpu",))`` and the port's
``export_forecaster`` export the tiny config in fp32 from one parameter set
(the JAX tree through ``params_to_state_dict``); both artifacts, loaded back
from disk, forecast the same windows within 1e-4 (fp32 sums in another order
through two stacks), at a symbolic batch of 3 and of 1. In a file of its own:
the XLA compile of the JAX artifact is slow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.synthetic import grid_coordinates as jax_grid
from tec_mollm_tpu.graph.builder import GraphData as JaxGraphData
from tec_mollm_tpu.graph.builder import build_graph as jax_build_graph
from tec_mollm_tpu.serving.export import export_forecaster as jax_export
from tec_mollm_tpu.serving.export import load_forecaster as jax_load
from tec_mollm_tpu.serving.export import save_exported as jax_save
from tec_mollm_tpu_torch.graph import GraphData
from tec_mollm_tpu_torch.models import params_to_state_dict
from tec_mollm_tpu_torch.serving import export as ex
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _fp32(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=False)).resolved()


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_artifacts_agree(tmp_path, fused):
    """The port's artifact (with the fused kernels' ops, or without) against
    JAX's, which exports its default model."""
    from tec_mollm_tpu.models import TECMoLLM
    from tec_mollm_tpu.models.tec_mollm import graph_inputs

    jc, pc = _fp32(jcfg.tiny_config()), _fp32(pcfg.tiny_config())
    m = jc.model
    graph = jax_build_graph(*jax_grid(m.grid_h, m.grid_w))
    graph.save(str(tmp_path / "graph.npz"))
    shifts, (valid, _) = graph_inputs(graph)
    params = TECMoLLM(m, stencil_shifts=shifts).init(
        jax.random.key(1), jnp.zeros((1, m.temporal_seq_len, m.num_nodes, m.in_features)),
        jnp.zeros((1, m.temporal_seq_len, 4), jnp.int32), valid, valid,
    )["params"]
    rng = np.random.default_rng(1)
    flat = {
        k: (np.asarray(v) + 0.05 * rng.normal(size=np.shape(v))).astype(np.float32)
        for k, v in flatten_dict(jax.device_get(params), sep="/").items()
    }
    jpath, ppath = str(tmp_path / "m.stablehlo"), str(tmp_path / "m.pt2")
    jax_save(jax_export(jc, unflatten_dict(flat, sep="/"), JaxGraphData.load(str(tmp_path / "graph.npz")),
                        platforms=("cpu",)), jpath)
    pgraph = GraphData.load(str(tmp_path / "graph.npz"))
    flags = dict(fused_attn=True, use_fused_mlp=True) if fused else {}
    ep = ex.export_forecaster(pc, params_to_state_dict(flat, pc.model), pgraph, platforms=("cpu",), **flags)
    ex.save_exported(ep, ppath, meta=ex.artifact_meta(pc, pgraph, "in memory", ("cpu",)))
    jfn, pfn = jax_load(jpath), ex.load_forecaster(ppath, "cpu")
    for b in (3, 1):
        x = rng.normal(size=(b, m.temporal_seq_len, m.num_nodes, m.in_features)).astype(np.float32)
        tf = np.stack([rng.integers(0, n, size=(b, m.temporal_seq_len)) for n in (12, 366, 13, 4)],
                      axis=-1).astype(np.int32)
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(tf)))
        got = pfn(torch.from_numpy(x), torch.from_numpy(tf)).numpy()
        assert got.shape == want.shape == (b, m.prediction_horizon, m.num_nodes, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
