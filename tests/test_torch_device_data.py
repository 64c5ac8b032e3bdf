"""PyTorch port: the device-resident archive (``data/device_data.py``), after
the JAX package's tests/test_device_data.py.

* the window index space (count, stride, tail_frac, the segment filter) is
  the host dataset's and the JAX ``DeviceResidentDataset``'s, identically;
* the gather, on the host mirror and as tensors, reproduces the host
  pipeline's windows: x and y within 1e-6 (they are bit for bit: the same fp32
  affine constants in the same order), time features identical;
* ``BatchLoader(index_only=True)`` yields the host loader's windows, order and
  padding as window starts;
* a Trainer epoch in device mode gives the host path's losses within 1e-5 (the
  same batches and dropout draws: only the gather differs), the train CLI's
  ``--device-data`` trains, and evaluation and conformal calibration on a
  device dataset give the host path's metrics within 1e-5. All on the CPU in
  fp32, where the kernels' plain versions run."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu.data.device_data import DeviceResidentDataset as JaxDeviceDataset
from tec_mollm_tpu.data.preprocess import run_preprocess as jax_run_preprocess
from tec_mollm_tpu_torch import train as train_cli
from tec_mollm_tpu_torch.data import BatchLoader, SlidingWindowDataset, StandardScaler
from tec_mollm_tpu_torch.data.device_data import DeviceResidentDataset
from tec_mollm_tpu_torch.data.preprocess import run_preprocess
from tec_mollm_tpu_torch.evaluation import conformal, harness
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM
from tec_mollm_tpu_torch.training.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LEVELS = (0.1, 0.5, 0.9)


def _cfg(**train):
    c = pcfg.tiny_config()
    return dataclasses.replace(
        c, train=dataclasses.replace(c.train, **{"bf16": False, "epochs": 1, "train_stride": 2, "val_stride": 2,
                                                 **train}),
    ).resolved()


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    """The port's preprocess CLI output of a 300-step archive on the tiny grid."""
    cfg = _cfg()
    out = str(tmp_path_factory.mktemp("devdata"))
    run_preprocess(cfg.data, out, synthetic_steps=300, synthetic_grid=(cfg.model.grid_h, cfg.model.grid_w))
    return out


@pytest.fixture(scope="module")
def gapped(tmp_path_factory):
    """An archive with an outage, segmented (both packages' preprocess)."""
    cfg = _cfg()
    out = str(tmp_path_factory.mktemp("gapped"))
    jax_run_preprocess(jcfg.tiny_config().data, out, synthetic_steps=600,
                       synthetic_grid=(cfg.model.grid_h, cfg.model.grid_w), cadence_policy="segment",
                       synthetic_drop=(100, 5))
    return out


def _datasets(d, mode, cfg, stride=1, tail=1.0):
    L_in, L_out = cfg.train.L_in, cfg.train.L_out
    return (
        SlidingWindowDataset.from_dir(d, mode, L_in, L_out, stride=stride, tail_frac=tail),
        DeviceResidentDataset(d, mode, L_in, L_out, stride=stride, tail_frac=tail),
        JaxDeviceDataset(d, mode, L_in, L_out, stride=stride, tail_frac=tail),
    )


class TestIndexSpace:
    @pytest.mark.parametrize("stride, tail", [(1, 1.0), (3, 1.0), (1, 0.25)])
    def test_matches_host_dataset_and_jax(self, proc, stride, tail):
        host, dev, jdev = _datasets(proc, "train", _cfg(), stride, tail)
        assert len(dev) == len(host) > 0
        np.testing.assert_array_equal(dev.sample_indices, host.sample_indices)
        np.testing.assert_array_equal(dev.sample_indices, jdev.sample_indices)

    @pytest.mark.parametrize("mode", ["train", "val", "test"])
    def test_segment_filter_matches(self, gapped, mode):
        host, dev, jdev = _datasets(gapped, mode, _cfg())
        np.testing.assert_array_equal(dev.sample_indices, host.sample_indices)
        np.testing.assert_array_equal(dev.sample_indices, jdev.sample_indices)

    def test_missing_raw_files_give_actionable_error(self, proc, tmp_path):
        broken = tmp_path / "noraw"
        shutil.copytree(proc, broken)
        for f in broken.glob("*_raw.npz"):
            f.unlink()
        with pytest.raises(FileNotFoundError, match="preprocess"):
            DeviceResidentDataset(str(broken), "train", 16, 4)

    def test_l_out_beyond_the_horizon_raises(self, proc):
        with pytest.raises(ValueError, match="horizon"):
            DeviceResidentDataset(proc, "train", 16, 8)


class TestGather:
    @pytest.mark.parametrize("mode", ["train", "val", "test"])
    def test_host_mirror_is_bit_exact(self, proc, mode):
        host, dev, jdev = _datasets(proc, mode, _cfg())
        idxs = np.array([0, 1, len(host) - 1])
        hb, db, jb = host.gather_batch(idxs), dev.gather_batch(idxs), jdev.gather_batch(idxs)
        for k in ("x", "y", "time_features"):
            assert db[k].dtype == hb[k].dtype
            np.testing.assert_array_equal(db[k], hb[k], err_msg=k)
            np.testing.assert_array_equal(db[k], jb[k], err_msg=k)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_device_gather_matches_host_windows(self, proc, dtype):
        """x within 1e-6 of the host windows (fp32) or of their bf16 cast, y
        within 1e-6, time features identical, valid passed through."""
        host, dev, _ = _datasets(proc, "train", _cfg())
        split = dev.device_split("cpu", dtype)
        idxs = np.array([0, 2, 5, len(dev) - 1])
        starts = torch.from_numpy(dev.sample_indices[idxs].astype(np.int32))
        valid = torch.tensor([True, True, False, True])
        got = split.gather(starts, valid)
        want = host.gather_batch(idxs)
        assert got["x"].dtype == dtype and got["y"].dtype == torch.float32
        torch.testing.assert_close(got["x"], torch.from_numpy(want["x"]).to(dtype), atol=1e-6, rtol=0)
        torch.testing.assert_close(got["y"], torch.from_numpy(want["y"]), atol=1e-6, rtol=0)
        assert torch.equal(got["time_features"], torch.from_numpy(want["time_features"]))
        assert got["valid"] is valid
        assert dev.nbytes() == dev.tec.nbytes + dev.sw.nbytes + dev.tf.nbytes


class TestIndexLoader:
    @pytest.mark.parametrize("shuffle", [False, True])
    def test_starts_follow_the_host_loader(self, proc, shuffle):
        """Batch for batch: the host loader's windows are the windows at the
        index loader's starts, with the same validity (7 does not divide the
        split, so the last batch is padded)."""
        host, dev, _ = _datasets(proc, "train", _cfg())
        assert len(host) % 7
        kw = dict(batch_size=7, shuffle=shuffle, seed=3, drop_remainder=False)
        hl, il = BatchLoader(host, **kw), BatchLoader(dev, index_only=True, **kw)
        assert len(hl) == len(il)
        seen = []
        for hb, ib in zip(hl, il):
            assert set(ib) == {"starts", "valid"} and ib["starts"].dtype == np.int32
            np.testing.assert_array_equal(ib["valid"], hb["valid"])
            idx = np.searchsorted(dev.sample_indices, ib["starts"])
            np.testing.assert_array_equal(dev.gather_batch(idx)["x"], hb["x"])
            seen.extend(ib["starts"][ib["valid"]].tolist())
        assert sorted(seen) == dev.sample_indices.tolist()


def _trainer(d, cfg, device_data, workdir):
    t = cfg.train
    if device_data:
        train = DeviceResidentDataset(d, "train", t.L_in, t.L_out, stride=t.train_stride)
        val = DeviceResidentDataset(d, "val", t.L_in, t.L_out, stride=t.val_stride)
    else:
        train = SlidingWindowDataset.from_dir(d, "train", t.L_in, t.L_out, stride=t.train_stride)
        val = SlidingWindowDataset.from_dir(d, "val", t.L_in, t.L_out, stride=t.val_stride)
    graph = GraphData.load(os.path.join(d, "graph.npz"))
    scaler = StandardScaler.load(os.path.join(d, "target_scaler.npz"))
    return Trainer(cfg, train, val, graph, scaler, workdir=str(workdir), run_name="r", device="cpu")


class TestTrainer:
    def test_device_epoch_matches_host_epoch(self, proc, tmp_path):
        """One epoch of the tiny config (every dropout 0.1, shuffled, macro
        batch 4): the same updates, train and val losses and metrics within
        1e-5."""
        cfg = _cfg(shuffle=True)
        host = _trainer(proc, cfg, False, tmp_path / "h")
        dev = _trainer(proc, cfg, True, tmp_path / "d")
        assert dev.device_mode and not host.device_mode
        h, d = host.fit()[0], dev.fit()[0]
        assert h["updates"] == d["updates"] > 1
        for k in ("train_loss", "val_loss", "mae_avg", "rmse_avg"):
            np.testing.assert_allclose(d[k], h[k], rtol=1e-5, atol=1e-7, err_msg=k)

    def test_partial_final_batch_trains_and_is_masked(self, proc, tmp_path):
        """A split smaller than one macro batch still makes one padded,
        loss-masked update."""
        tr = _trainer(proc, _cfg(train_stride=64), True, tmp_path)
        assert 0 < len(tr.train_loader.dataset) < tr.macro_batch
        hist = tr.fit()
        assert hist[0]["updates"] == 1 and np.isfinite(hist[0]["train_loss"])

    def test_mixed_splits_are_refused(self, proc, tmp_path):
        t = _cfg().train
        graph = GraphData.load(os.path.join(proc, "graph.npz"))
        with pytest.raises(TypeError, match="device-resident"):
            Trainer(_cfg(), DeviceResidentDataset(proc, "train", t.L_in, t.L_out),
                    SlidingWindowDataset.from_dir(proc, "val", t.L_in, t.L_out), graph, None,
                    workdir=str(tmp_path), device="cpu")

    def test_train_cli_device_data(self, proc, tmp_path):
        cfg_path = tmp_path / "tiny.json"
        cfg_path.write_text(_cfg().to_json())
        argv = ["--cpu", "--config", str(cfg_path), "--data-dir", proc, "--workdir", str(tmp_path), "--run-name",
                "dd", "--epochs", "1", "--device-data"]
        hist = train_cli.main(argv)
        assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
        assert '"device_data": true' in (tmp_path / "checkpoints" / "dd" / "config.json").read_text()


@pytest.fixture(scope="module")
def quantile_run(proc, tmp_path_factory):
    """A seeded quantile checkpoint of the tiny config with RevIN."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantiles=LEVELS, revin=True)).resolved()
    d = tmp_path_factory.mktemp("qrun") / "checkpoints" / "q"
    os.makedirs(d)
    shifts = tuple(int(s) for s in build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w)).stencil_shifts)
    torch.save(TECMoLLM(cfg.model, shifts, seed=4).state_dict(), d / "best_params.pt")
    (d / "config.json").write_text(cfg.to_json())
    return cfg, str(d / "best_params.pt")


def _assert_metrics_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_metrics_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple, np.ndarray, float, int)):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=1e-5, atol=1e-7,
                                   err_msg=path)
    else:
        assert got == want, path


class TestEvaluation:
    def test_run_evaluation_on_the_device_archive(self, proc, quantile_run, tmp_path):
        """run_evaluation with device_data (conformal fit on val, then the
        adaptive pass on test) against the same run on the host pipeline."""
        cfg, ckpt = quantile_run
        out = {}
        for device_data in (False, True):
            c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, device_data=device_data))
            out[device_data] = harness.run_evaluation(
                c, proc, ckpt, output_dir=str(tmp_path / str(device_data)), batch_size=5, conformal="fit",
                conformal_mode="adaptive", device="cpu",
            )
        _assert_metrics_close(out[True], out[False])
        assert "quantile_metrics_adaptive" in out[True]["results"]["TEC-MoLLM"]

    def test_eval_dataset_falls_back_without_raw_files(self, proc, tmp_path, caplog):
        broken = tmp_path / "noraw"
        shutil.copytree(proc, broken)
        for f in broken.glob("*_raw.npz"):
            f.unlink()
        cfg = _cfg(device_data=True)
        assert isinstance(harness.eval_dataset(cfg, proc, "test"), DeviceResidentDataset)
        assert isinstance(harness.eval_dataset(cfg, str(broken), "test"), SlidingWindowDataset)
        assert "falling back" in caplog.text

    def test_conformal_fit_on_a_device_dataset(self, proc, quantile_run):
        cfg, ckpt = quantile_run
        state = harness.load_params_for_eval(cfg, ckpt)
        graph = GraphData.load(os.path.join(proc, "graph.npz"))
        scaler = StandardScaler.load(os.path.join(proc, "target_scaler.npz"))
        host, dev, _ = _datasets(proc, "val", cfg)
        want = conformal.fit_conformal(cfg, state, host, graph, scaler, batch_size=4, device="cpu")
        got = conformal.fit_conformal(cfg, state, dev, graph, scaler, batch_size=4, device="cpu")
        np.testing.assert_allclose(got.offsets, want.offsets, rtol=1e-5, atol=1e-7)
