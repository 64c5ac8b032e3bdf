"""The reference and the counts against the program, on the CPU at a tiny size."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, graphfile, harness, spec, weights
from benchmark.reference import graph as graph_lib
from benchmark.reference import model as ref


def merged(tiny: dict) -> dict:
    """The flagship configuration at the tests' tiny sizes (float32)."""
    return harness.merge(spec.config("flagship"), tiny["config"])


def program_model(cfg: dict, **kw):
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.graph.builder import GraphData
    from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM, graph_inputs

    conf = Config.from_dict({k: cfg[k] for k in ("model", "train", "data")}).resolved()
    arrays = graphfile.arrays(cfg)
    arrays["num_nodes"] = int(arrays["num_nodes"])
    shifts, graph = graph_inputs(GraphData(**arrays), "cpu")
    return TECMoLLM(conf.model, shifts, **kw), graph


@pytest.mark.parametrize("name", ["flagship", "scale_up"])
def test_specs_are_the_program_state_dict(name):
    from tec_mollm_tpu_torch.config import Config
    from tec_mollm_tpu_torch.models.tec_mollm import TECMoLLM

    cfg = spec.config(name)
    conf = Config.from_dict({k: cfg[k] for k in ("model", "train", "data")}).resolved()
    with torch.device("meta"):
        model = TECMoLLM(conf.model, (0, 1), seed=None)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: s for n, s, _, _ in ref.specs(ref.Dims.of(cfg))}
    assert got == want


def test_forward_matches_the_program(tiny):
    cfg = merged(tiny)
    params = weights.make(cfg, 5, "cpu")
    model, graph = program_model(cfg, seed=None)
    model.load_state_dict(params)
    model.eval()
    dims = ref.Dims.of(cfg)
    g = np.random.default_rng(0)
    x = torch.as_tensor(g.standard_normal((3, dims.l_in, dims.n, dims.c_raw)), dtype=torch.float32)
    tf = torch.as_tensor(np.stack([g.integers(0, v, (3, dims.l_in)) for v in (12, 366, 13, 4)], -1))
    with torch.no_grad():
        want = model(x, tf, *graph)
        got = ref.forward(params, x, tf, ref.Graph(cfg, "cpu"), dims, ref.Precision())
        fp8 = ref.forward(params, x, tf, ref.Graph(cfg, "cpu"), dims, ref.Precision(fp8=True))
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()
    assert (fp8 - want).abs().max() > 100 * (got - want).abs().max()


@pytest.mark.parametrize("grid", [(6, 8), (41, 71)])
def test_graph_offsets_match_the_program_stencil_and_the_distances(grid):
    from tec_mollm_tpu_torch.graph.builder import build_grid_stencil, grid_coordinates

    lat, lon = grid_coordinates(*grid)
    shifts, index, valid = graph_lib.offsets(lat, lon, 150.0, 6371.0)
    p_shifts, p_valid = build_grid_stencil(lat, lon, 150.0, 6371.0)
    assert shifts.tolist() == p_shifts.tolist()
    assert (valid == p_valid).all()
    if grid == (6, 8):
        dense = graph_lib.dense_neighbors(lat, lon, 150.0, 6371.0)
        for n in range(len(dense)):
            assert set(index[valid[:, n], n].tolist()) == dense[n]


def test_graph_file_loads_in_the_program(tiny):
    from tec_mollm_tpu_torch.graph.builder import build_graph, grid_coordinates

    cfg = merged(tiny)
    got = graphfile.arrays(cfg)
    want = build_graph(*grid_coordinates(6, 8))
    for k in ("edge_index", "edge_weight", "neighbors", "neighbor_mask", "stencil_shifts", "stencil_valid"):
        np.testing.assert_allclose(got[k], getattr(want, k), rtol=1e-6)


def test_forward_flops_count_the_program_products(tiny):
    cfg = merged(tiny)
    model, graph = program_model(cfg)
    model.eval()
    dims = ref.Dims.of(cfg)
    x = torch.zeros(2, dims.l_in, dims.n, dims.c_raw)
    tf = torch.zeros(2, dims.l_in, 4, dtype=torch.long)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, tf, *graph)
    assert fc.get_total_flops() == pytest.approx(2 * counts.forward_flops(cfg), rel=1e-9)


def test_train_flops_count_the_program_products(tiny):
    from tec_mollm_tpu_torch.training.optimizer import trainable_mask

    cfg = merged(tiny)
    model, graph = program_model(cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_mask(model)[name])
    model.train()
    dims = ref.Dims.of(cfg)
    x = torch.randn(2, dims.l_in, dims.n, dims.c_raw)
    tf = torch.zeros(2, dims.l_in, 4, dtype=torch.long)
    with FlopCounterMode(display=False) as fc:
        model(x, tf, *graph).square().sum().backward()
    assert fc.get_total_flops() == pytest.approx(2 * counts.train_flops(cfg), rel=1e-9)


def test_flagship_counts():
    cfg = spec.config("flagship")
    assert counts.forward_flops(cfg) == pytest.approx(0.419e12, rel=1e-2)
    flops, nbytes = counts.gat_span(cfg, 16)
    least, by = counts.least_seconds(flops, nbytes, "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and least == pytest.approx(nbytes / 3.35e12)
