"""PyTorch port: config, graph, dataset and scaler against the JAX package.

These are host-side numpy layers, so the port must agree exactly (config JSON
text, graph arrays, gathered windows) or to float64 rounding (scaler)."""

import dataclasses
import json

import numpy as np
import pytest

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.dataset import SlidingWindowDataset as JaxDataset
from tec_mollm_tpu.data.hdf5_io import valid_window_starts as jax_valid_starts
from tec_mollm_tpu.data.scaler import StandardScaler as JaxScaler
from tec_mollm_tpu.data.synthetic import grid_coordinates as jax_grid
from tec_mollm_tpu.graph import GraphData as JaxGraphData
from tec_mollm_tpu.graph import build_graph as jax_build_graph
from tec_mollm_tpu_torch.data import SlidingWindowDataset, StandardScaler, valid_window_starts
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates

PRESETS = sorted(jcfg.PRESETS)


class TestConfig:
    @pytest.mark.parametrize("name", PRESETS)
    def test_presets_serialize_identically(self, name):
        assert pcfg.PRESETS[name]().to_json() == jcfg.PRESETS[name]().to_json()

    def test_preset_names_match(self):
        assert sorted(pcfg.PRESETS) == PRESETS

    def test_json_round_trip_across_packages(self):
        cfg = jcfg.tiny_config()
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, revin=True, quantiles=(0.1, 0.5, 0.9))
        )
        port = pcfg.Config.from_json(cfg.to_json())
        assert port.to_json() == cfg.to_json()
        assert jcfg.Config.from_json(port.to_json()) == cfg
        assert port.model.quantiles == (0.1, 0.5, 0.9) and port.model.num_outputs == 3

    def test_tiny_and_resolved_match(self):
        assert pcfg.tiny_config().to_json() == jcfg.tiny_config().to_json()
        for attr in ("num_patches", "effective_patch_len", "head_input_dim", "spatial_channels"):
            assert getattr(pcfg.Config().resolved().model, attr) == getattr(
                jcfg.Config().resolved().model, attr
            )

    def test_unknown_key_rejected(self):
        with pytest.raises(KeyError, match="Unknown config key"):
            pcfg.Config.from_dict({"model": {"no_such_field": 1}})

    def test_load_config_path(self, tmp_path):
        p = tmp_path / "config.json"
        p.write_text(jcfg.tiny_config().to_json())
        assert pcfg.load_config(str(p)).to_json() == jcfg.tiny_config().to_json()
        assert pcfg.load_config("operational").model.revin


def _graph_arrays(g):
    return {
        "edge_index": g.edge_index, "edge_weight": g.edge_weight, "neighbors": g.neighbors,
        "neighbor_mask": g.neighbor_mask, "neighbor_weight": g.neighbor_weight,
        "stencil_shifts": g.stencil_shifts, "stencil_valid": g.stencil_valid,
    }


class TestGraph:
    @pytest.mark.parametrize("grid", [(5, 7), (6, 8), (41, 71)])
    def test_arrays_equal(self, grid):
        port = build_graph(*grid_coordinates(*grid))
        ref = jax_build_graph(*jax_grid(*grid))
        assert port.num_nodes == ref.num_nodes
        for key, want in _graph_arrays(ref).items():
            got = _graph_arrays(port)[key]
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)

    def test_flagship_stencil_offsets(self):
        g = build_graph(*grid_coordinates(41, 71))
        assert g.num_nodes == 2911
        assert sorted(g.stencil_shifts.tolist()) == [-72, -71, -70, -2, -1, 0, 1, 2, 70, 71, 72]

    def test_grid_coordinates_equal(self):
        for a, b in zip(grid_coordinates(41, 71), jax_grid(41, 71)):
            np.testing.assert_array_equal(a, b)

    def test_graph_npz_interchanges(self, tmp_path):
        port = build_graph(*grid_coordinates(6, 8))
        port.save(str(tmp_path / "p.npz"))
        back = JaxGraphData.load(str(tmp_path / "p.npz"))
        jax_build_graph(*jax_grid(6, 8)).save(str(tmp_path / "j.npz"))
        forth = GraphData.load(str(tmp_path / "j.npz"))
        for key, want in _graph_arrays(port).items():
            np.testing.assert_array_equal(_graph_arrays(back)[key], want)
            np.testing.assert_array_equal(_graph_arrays(forth)[key], want)


@pytest.fixture(scope="module")
def split():
    rng = np.random.default_rng(3)
    t, n = 60, 12
    seg = np.zeros(t, np.int64)
    seg[25:] = 1
    seg[40] = -1
    return {
        "X": rng.normal(size=(t, n, 6)).astype(np.float32),
        "Y": rng.normal(size=(t, n, 4)).astype(np.float32),
        "time_features": rng.integers(0, 4, size=(t, 4)).astype(np.int32),
        "segment_id": seg,
    }


class TestDataset:
    @pytest.mark.parametrize("stride", [1, 3])
    def test_windows_and_batches_equal(self, split, stride):
        port = SlidingWindowDataset(split, L_in=8, L_out=4, stride=stride)
        ref = JaxDataset(split, L_in=8, L_out=4, stride=stride, use_native=False)
        np.testing.assert_array_equal(port.sample_indices, ref.sample_indices)
        idx = np.arange(len(port))[::2]
        got, want = port.gather_batch(idx), ref.gather_batch(idx)
        for key in ("x", "y", "time_features"):
            np.testing.assert_array_equal(got[key], want[key])

    def test_valid_window_starts_equal(self, split):
        starts = np.arange(0, 49)
        np.testing.assert_array_equal(
            valid_window_starts(starts, split["segment_id"], 8, 4),
            jax_valid_starts(starts, split["segment_id"], 8, 4),
        )

    def test_from_dir(self, split, tmp_path):
        np.savez(tmp_path / "test_set.npz", **split)
        port = SlidingWindowDataset.from_dir(str(tmp_path), "test", 8, 4)
        ref = JaxDataset.from_dir(str(tmp_path), "test", 8, 4)
        np.testing.assert_array_equal(port.sample_indices, ref.sample_indices)

    def test_grid_shaped_input_rejected(self, split):
        bad = dict(split, X=split["X"].reshape(60, 3, 4, 6))
        with pytest.raises(ValueError, match="node-flattened"):
            SlidingWindowDataset(bad, L_in=8, L_out=4)

    def test_short_split_has_no_windows(self, split):
        short = {k: v[:10] for k, v in split.items() if k != "segment_id"}
        assert len(SlidingWindowDataset(short, L_in=8, L_out=4)) == 0


class TestScaler:
    def test_inverse_transform_matches_and_loads_jax_file(self, tmp_path):
        rng = np.random.default_rng(0)
        ref = JaxScaler().fit(rng.normal(20.0, 7.0, size=(500, 3)))
        ref.save(str(tmp_path / "s.npz"))
        port = StandardScaler.load(str(tmp_path / "s.npz"))
        z = rng.normal(size=(40, 3))
        np.testing.assert_allclose(port.inverse_transform(z), ref.inverse_transform(z), rtol=1e-12)
        port.save(str(tmp_path / "p.npz"))
        np.testing.assert_array_equal(JaxScaler.load(str(tmp_path / "p.npz")).mean_, ref.mean_)
        assert json.dumps(port.scale_.tolist()) == json.dumps(ref.scale_.tolist())
