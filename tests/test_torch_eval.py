"""PyTorch port: evaluation against the JAX package's functions (the
end-to-end ``run_evaluation`` parity is tests/test_torch_eval_jax.py).

The same inputs, drawn with numpy from a seed, go through the JAX function and
the port's: the numpy metric functions and the baselines (rtol 1e-6), the
streaming quantile metrics (rtol 1e-6), the conformal residual histograms
(counts identical), the offsets inverted from the same histograms (1e-6), a
``conformal.npz`` written by one package and read by the other, the
autoregressive rollout (1e-4) and a reference checkpoint's forward through
each package's importer (1e-5). Then the checkpoint and config resolution
policy, and the test and predict CLIs on the CPU with their refusals."""

import dataclasses
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ref_import import make_fake_reference_state_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu.evaluation.conformal as jconf
import tec_mollm_tpu.evaluation.metrics as jmetrics
import tec_mollm_tpu.evaluation.streaming as jstream
import tec_mollm_tpu.models.baselines as jbase
import tec_mollm_tpu_torch.config as pcfg
import tec_mollm_tpu_torch.evaluation.conformal as pconf
import tec_mollm_tpu_torch.evaluation.metrics as pmetrics
import tec_mollm_tpu_torch.evaluation.streaming as pstream
import tec_mollm_tpu_torch.models.baselines as pbase
from tec_mollm_tpu.evaluation.rollout import autoregressive_rollout as jax_rollout
from tec_mollm_tpu.graph.builder import GraphData as JaxGraphData
from tec_mollm_tpu.models import TECMoLLM as JaxTECMoLLM
from tec_mollm_tpu.models.ref_import import reference_state_dict_to_params
from tec_mollm_tpu_torch import predict as predict_cli
from tec_mollm_tpu_torch import test as test_cli
from tec_mollm_tpu_torch.data import StandardScaler
from tec_mollm_tpu_torch.evaluation import harness
from tec_mollm_tpu_torch.evaluation.rollout import autoregressive_rollout
from tec_mollm_tpu_torch.graph import GraphData, build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.models.ref_import import load_reference_checkpoint, reference_state_dict_to_port
from tec_mollm_tpu_torch.training.checkpoint import find_latest_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TARGET_MEAN, TARGET_SCALE = 25.0, 12.0
LEVELS = (0.1, 0.5, 0.9)


def tiny(mod=pcfg, revin=False, quantiles=()):
    """tiny_config at fp32 with every dropout 0, optionally RevIN and a
    quantile head."""
    c = mod.tiny_config()
    model = dataclasses.replace(
        c.model, gat_dropout=0.0, lora_dropout=0.0, llm_dropout=0.0, head_dropout=0.0, post_llm_dropout=0.0,
        revin=revin, quantiles=quantiles,
    )
    return dataclasses.replace(c, model=model, train=dataclasses.replace(c.train, bf16=False)).resolved()


def write_eval_dir(path, cfg, lengths=(60, 40, 60), seed=0):
    """A processed dir as the preprocess CLI writes it, of a TEC-like scaled
    series: a level per node (the grid's spatial gradient), a diurnal cycle of
    12 steps and noise; Y holds the next L_out TEC steps, and the target and
    feature scalers map it to TECU around TARGET_MEAN."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    n, L_out = cfg.model.num_nodes, cfg.train.L_out
    level = np.linspace(-1.5, 1.5, n)[None, :]
    for split, length in zip(("train", "val", "test"), lengths):
        t = np.arange(length + L_out)
        tec = level + 0.5 * np.sin(2 * np.pi * t / 12.0)[:, None] + 0.3 * rng.standard_normal((len(t), n))
        weather = 0.5 * rng.standard_normal((len(t), 1, cfg.model.in_features - 1)).repeat(n, axis=1)
        x = np.concatenate([tec[:, :, None], weather], axis=-1)[:length]
        y = np.stack([tec[h + 1 : h + 1 + length] for h in range(L_out)], axis=-1)
        tf = np.stack([t % 12, (t // 12) % 366, np.full_like(t, 3), ((t // 12) // 91) % 4], axis=-1)[:length]
        np.savez(os.path.join(path, f"{split}_set.npz"), X=x.astype(np.float32), Y=y.astype(np.float32),
                 time_features=tf.astype(np.int32))
    build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w)).save(os.path.join(path, "graph.npz"))
    StandardScaler(np.array([TARGET_MEAN]), np.array([TARGET_SCALE])).save(os.path.join(path, "target_scaler.npz"))
    StandardScaler(np.r_[TARGET_MEAN, np.zeros(5)], np.r_[TARGET_SCALE, np.ones(5)]).save(
        os.path.join(path, "scaler.npz"))
    return path


def save_run(workdir, run, cfg, seed, mtime=None):
    """``<workdir>/checkpoints/<run>/{best_params.pt, config.json}`` with the
    port's seeded initial weights; returns the checkpoint path."""
    d = os.path.join(workdir, "checkpoints", run)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "best_params.pt")
    shifts = tuple(int(s) for s in build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w)).stencil_shifts)
    torch.save(TECMoLLM(cfg.model, shifts, seed=seed).state_dict(), path)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg.to_json())
    if mtime is not None:
        os.utime(path, (mtime, mtime))
    return path


def _batches(rng, n_batches=3, b=6, l_out=4, m=20, nq=3):
    """(truth, quantile forecast, valid) in scaled units, with non-finite
    forecasts, values past the clip and padded rows."""
    out = []
    for _ in range(n_batches):
        base = rng.normal(0.0, 1.0, size=(b, l_out, m, 1)).astype(np.float32)
        yt = (base[..., 0] + rng.normal(0.0, 0.8, size=(b, l_out, m))).astype(np.float32)
        yp = (base + np.sort(rng.normal(0.0, 0.3, size=(b, l_out, m, nq)), axis=-1)).astype(np.float32)
        yp[0, 0, 0, 0] = np.nan
        yp[0, 1, 1, 2] = np.inf
        yp[1, 0, 2, :] = 30.0  # past 200 TECU: clipped
        valid = np.ones(b, dtype=bool)
        valid[-2:] = False
        out.append((yt, yp, valid))
    return out


SCALER = StandardScaler(np.array([TARGET_MEAN]), np.array([TARGET_SCALE]))


def _jax_scaler():
    from tec_mollm_tpu.data.scaler import StandardScaler as JaxScaler

    return JaxScaler(mean=np.array([TARGET_MEAN]), scale=np.array([TARGET_SCALE]))


def _assert_dicts_close(got, want, rtol, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64), np.asarray(want[k], dtype=np.float64),
                                       rtol=rtol, atol=atol, err_msg=k)


class TestMetricFunctions:
    """The numpy metric functions, copied: the same numbers (rtol 1e-6)."""

    @pytest.mark.parametrize("name", [
        "_mae", "_rmse", "_r2", "_pearson", "evaluate_metrics", "evaluate_metrics_no_scaler",
        "evaluate_metrics_unscaled_fallback", "evaluate_horizons",
    ])
    def test_matches_jax(self, name):
        rng = np.random.default_rng(3)
        yt = rng.normal(size=(7, 4, 12, 1))
        yp = yt + 0.3 * rng.normal(size=yt.shape)
        yp[0, 0, 0, 0], yp[1, 2, 3, 0] = np.nan, np.inf
        yt[..., 5, 0] = yt[0, 0, 5, 0]  # a zero-variance column
        jsc = _jax_scaler()
        flat_t, flat_p = yt.reshape(7, -1), np.nan_to_num(yp.reshape(7, -1), posinf=0.0)
        calls = {
            "_mae": lambda m: m._mae(flat_t, flat_p),
            "_rmse": lambda m: m._rmse(flat_t, flat_p),
            "_r2": lambda m: m._r2(flat_t, flat_p),
            "_pearson": lambda m: m._pearson(flat_t.ravel(), flat_p.ravel()),
            "evaluate_metrics": lambda m: m.evaluate_metrics(yt[:, 1], yp[:, 1], SCALER if m is pmetrics else jsc),
            "evaluate_metrics_no_scaler": lambda m: m.evaluate_metrics(yt[:, 1] * 20, yp[:, 1] * 20, None),
            "evaluate_metrics_unscaled_fallback":
                lambda m: m.evaluate_metrics_unscaled_fallback(yt[:, 2, :, 0] * 20, flat_p[:, :12] * 20),
            "evaluate_horizons": lambda m: m.evaluate_horizons(yt, yp, SCALER if m is pmetrics else jsc),
        }
        got, want = calls[name](pmetrics), calls[name](jmetrics)
        if isinstance(want, dict):
            _assert_dicts_close(got, want, rtol=1e-6)
        else:
            assert got == pytest.approx(want, rel=1e-6)

    def test_streaming_horizons_match_evaluate_horizons(self):
        """The device statistics against the host functions on the same
        guarded values (rtol 1e-5: fp32 sums of a batch)."""
        rng = np.random.default_rng(4)
        acc = pstream.StreamingHorizonMetrics(4, SCALER)
        trues, preds = [], []
        for yt, yp, valid in _batches(rng):
            p = yp[..., 1:2]
            acc.update(torch.from_numpy(yt[..., None]), torch.from_numpy(p), torch.from_numpy(valid))
            trues.append(yt[valid][..., None])
            preds.append(p[valid])
        want = pmetrics.evaluate_horizons(np.concatenate(trues), np.concatenate(preds), SCALER)
        _assert_dicts_close(acc.finalize(), want, rtol=1e-5)


class TestBaselines:
    @pytest.mark.parametrize("name", ["window_mean", "historical_average", "seasonal_naive"])
    def test_matches_jax(self, name):
        rng = np.random.default_rng(5)
        window = rng.normal(size=(3, 16, 10)).astype(np.float32)
        if name == "window_mean":
            got, want = (m.WindowMeanBaseline().predict_batch(window, 4) for m in (pbase, jbase))
        elif name == "seasonal_naive":
            got, want = (m.SeasonalNaive(12).predict_batch(window, 14) for m in (pbase, jbase))
        else:
            tec, slots = rng.normal(size=(50, 10)), np.arange(50) % 12
            got, want = (m.HistoricalAverage(12).fit(tec, slots).predict(np.array([0, 5, 11])) for m in (pbase, jbase))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestStreamingQuantileMetrics:
    @pytest.mark.parametrize("offsets", ["raw", "additive", "scale", "override"])
    def test_matches_jax(self, offsets):
        """Finalized pinball, calibration and coverage within rtol 1e-6, with
        padded rows, non-finite forecasts and clipped values."""
        rng = np.random.default_rng(6)
        off = rng.normal(0.0, 2.0, size=(4, 3))
        conf = {"additive": "additive", "scale": "scale"}.get(offsets)
        kw_p = {"offsets": pconf.ConformalOffsets(LEVELS, off, mode=conf)} if conf else {}
        kw_j = {"offsets": jconf.ConformalOffsets(LEVELS, off, mode=conf)} if conf else {}
        port = pstream.StreamingQuantileMetrics(4, LEVELS, SCALER, **kw_p)
        ref = jstream.StreamingQuantileMetrics(4, LEVELS, _jax_scaler(), **kw_j)
        for yt, yp, valid in _batches(rng):
            over = {"offsets_override": off} if offsets == "override" else {}
            s = port.update(torch.from_numpy(yt), torch.from_numpy(yp), torch.from_numpy(valid), **over)
            sj = ref.update(jnp.asarray(yt), jnp.asarray(yp), jnp.asarray(valid), **over)
            np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6)
        _assert_dicts_close(port.finalize(), ref.finalize(), rtol=1e-6)


class TestConformal:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_residual_hist_counts_identical(self, seed):
        rng = np.random.default_rng(10 + seed)
        for yt, yp, valid in _batches(rng):
            got = pconf.batch_residual_hist(torch.from_numpy(yt), torch.from_numpy(yp), torch.from_numpy(valid),
                                            TARGET_SCALE, TARGET_MEAN, 3)
            want = jconf.batch_residual_hist(jnp.asarray(yt), jnp.asarray(yp), jnp.asarray(valid),
                                             jnp.float32(TARGET_SCALE), jnp.float32(TARGET_MEAN), 3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert float(got.sum()) == valid.sum() * yt[0].size * 3

    @pytest.mark.parametrize("seed", [0, 1])
    def test_scaled_residual_hist_counts_identical(self, seed):
        rng = np.random.default_rng(20 + seed)
        for yt, yp, valid in _batches(rng):
            got = pconf.batch_scaled_residual_hist(torch.from_numpy(yt), torch.from_numpy(yp),
                                                   torch.from_numpy(valid), TARGET_SCALE, TARGET_MEAN, 3, 1)
            want = jconf.batch_scaled_residual_hist(jnp.asarray(yt), jnp.asarray(yp), jnp.asarray(valid),
                                                    jnp.float32(TARGET_SCALE), jnp.float32(TARGET_MEAN), 3, 1)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("mode", ["additive", "scale"])
    def test_calibrator_offsets_match(self, mode):
        """The same batches -> the same counts -> offsets within 1e-6."""
        rng = np.random.default_rng(30)
        port = pconf.ConformalCalibrator(4, LEVELS, SCALER, mode=mode)
        ref = jconf.ConformalCalibrator(4, LEVELS, _jax_scaler(), mode=mode)
        for yt, yp, valid in _batches(rng, n_batches=5):
            port.update(torch.from_numpy(yt), torch.from_numpy(yp), torch.from_numpy(valid))
            ref.update(jnp.asarray(yt), jnp.asarray(yp), jnp.asarray(valid))
        got, want = port.finalize(), ref.finalize()
        np.testing.assert_allclose(got.offsets, want.offsets, rtol=0, atol=1e-6)
        assert (got.mode, got.quantiles, got.n_calibration) == (want.mode, want.quantiles, want.n_calibration)

    def test_offsets_from_histograms_match(self):
        rng = np.random.default_rng(31)
        hist = rng.integers(0, 5, size=(4, 3, pconf.BINS)).astype(np.float64)
        hist[2, 1] = 0.0  # an empty histogram gives 0
        for q in (LEVELS, (0.05, 0.5, 0.95)):
            np.testing.assert_allclose(pconf.offsets_from_histograms(hist, q), jconf.offsets_from_histograms(hist, q),
                                       rtol=0, atol=1e-6)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    @pytest.mark.parametrize("mode", ["additive", "scale"])
    def test_npz_read_by_the_other_package(self, tmp_path, writer, mode):
        off = np.random.default_rng(32).normal(size=(4, 3))
        write, read = (pconf, jconf) if writer == "port" else (jconf, pconf)
        path = str(tmp_path / "conformal.npz")
        write.ConformalOffsets(LEVELS, off, n_calibration=123.0, mode=mode).save(path)
        back = read.ConformalOffsets.load(path)
        assert (back.quantiles, back.n_calibration, back.mode) == (LEVELS, 123.0, mode)
        np.testing.assert_array_equal(back.offsets, off)
        yp = np.sort(np.random.default_rng(33).uniform(0, 80, size=(2, 4, 5, 3)), axis=-1)
        np.testing.assert_array_equal(back.apply_physical(yp), write.ConformalOffsets.load(path).apply_physical(yp))


class TestRollout:
    def test_matches_jax(self, tmp_path):
        """Two chunks fed back, the median level of a quantile + RevIN head, the
        same weights through the reference importer: within 1e-4."""
        pc, jc = tiny(revin=True, quantiles=LEVELS), tiny(jcfg, revin=True, quantiles=LEVELS)
        proc = write_eval_dir(str(tmp_path / "proc"), pc)
        graph, jgraph = GraphData.load(f"{proc}/graph.npz"), JaxGraphData.load(f"{proc}/graph.npz")
        state = TECMoLLM(pc.model, tuple(int(s) for s in graph.stencil_shifts), seed=7).state_dict()
        params = reference_state_dict_to_params({k: v.numpy() for k, v in state.items()}, jc.model)
        rng = np.random.default_rng(8)
        L_in, steps = pc.train.L_in, 2 * pc.train.L_out - 1
        x = rng.normal(size=(2, L_in, pc.model.num_nodes, 6)).astype(np.float32)
        t = np.arange(L_in + 8)
        tf = np.stack([np.stack([t % 12, t // 12, np.full_like(t, 3), t % 4], axis=-1)] * 2).astype(np.int32)
        sw = rng.normal(size=(2, 8, 5)).astype(np.float32)
        fs = StandardScaler(np.r_[20.0, np.zeros(5)], np.r_[10.0, np.ones(5)])
        got = autoregressive_rollout(pc, state, graph, x, tf, sw, steps, fs, SCALER, device="cpu")
        want = jax_rollout(jc, params, jgraph, x, tf, sw, steps, fs, SCALER)
        assert got.shape == want.shape == (2, steps, pc.model.num_nodes, 1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestCheckpointPolicy:
    def test_latest_is_newest_by_mtime_within_run_name(self, tmp_path):
        cfg = tiny()
        old = save_run(tmp_path, "old", cfg, 0, mtime=1_000_000)
        new = save_run(tmp_path, "new", cfg, 1, mtime=2_000_000)
        root = str(tmp_path / "checkpoints")
        assert find_latest_checkpoint(root) == new
        assert find_latest_checkpoint(root, run_name="old") == old
        assert harness.resolve_checkpoint("latest", str(tmp_path)) == new
        assert harness.resolve_checkpoint("latest", str(tmp_path), run_name="old") == old
        os.makedirs(tmp_path / "checkpoints" / "empty")
        with pytest.raises(FileNotFoundError, match="best_params.pt"):
            find_latest_checkpoint(root, run_name="empty")
        with pytest.raises(FileNotFoundError):
            find_latest_checkpoint(str(tmp_path / "nowhere"))

    def test_relative_path_resolves_against_the_workdir(self, tmp_path, monkeypatch):
        path = save_run(tmp_path / "wd", "r", tiny(), 0)
        monkeypatch.chdir(tmp_path)
        rel = os.path.join("checkpoints", "r", "best_params.pt")
        assert harness.resolve_checkpoint(rel, "wd") == os.path.join("wd", rel)
        assert os.path.samefile(harness.resolve_checkpoint(rel, "wd"), path)
        assert harness.resolve_checkpoint("missing.pt", "wd") == "missing.pt"

    def test_cli_config_policy(self, tmp_path, caplog):
        point, quant = tiny(), tiny(revin=True, quantiles=LEVELS)
        p_path = save_run(tmp_path, "p", point, 0, mtime=1_000_000)
        q_path = save_run(tmp_path, "q", quant, 1, mtime=2_000_000)
        cfg, ck = harness.resolve_cli_config(None, "latest", str(tmp_path))
        assert (cfg.model.quantiles, ck) == (LEVELS, q_path)
        cfg, ck = harness.resolve_cli_config(None, "latest", str(tmp_path), run_name="p")
        assert (cfg.model.quantiles, ck) == ((), p_path)
        cfg, ck = harness.resolve_cli_config("operational", "latest", str(tmp_path), run_name="p")
        assert (cfg.model.num_nodes, cfg.model.revin, ck) == (2911, True, p_path)  # --config wins
        assert harness.warn_on_config_mismatch(cfg, ck)
        fallback = tiny()
        with caplog.at_level(logging.WARNING):
            cfg, ck = harness.resolve_cli_config(None, "latest", str(tmp_path / "none"), fallback=fallback)
        assert (cfg, ck) == (fallback, "latest")
        assert "no config.json found next to the checkpoint" in caplog.text


class TestReferenceImport:
    @pytest.mark.parametrize("prefix", ["module.", "_orig_mod."])
    def test_forward_matches_flax_of_the_jax_import(self, tmp_path, prefix):
        """A reference .pth (a DDP or compile prefix, peft names, GPT-2's wte and
        mask buffers, a node table of more rows than the grid) through the
        port's loader and through JAX's importer: forwards within 1e-5."""
        jc, pc = jcfg.tiny_config(), pcfg.tiny_config()
        m = dataclasses.replace(jc.model, num_nodes=jc.model.num_nodes + 7)
        sd = make_fake_reference_state_dict(m, seed=3)
        llm = "llm_backbone.model.base_model.model"
        sd[f"{llm}.wte.weight"] = torch.zeros(50, m.d_llm)
        sd[f"{llm}.h.0.attn.bias"] = torch.ones(1, 1, 8, 8)
        path = str(tmp_path / "best_model.pth")
        torch.save({prefix + k: v for k, v in sd.items()}, path)

        graph = build_graph(*grid_coordinates(pc.model.grid_h, pc.model.grid_w))
        shifts = tuple(int(s) for s in graph.stencil_shifts)
        port = TECMoLLM(pc.model, shifts, seed=None)
        port.load_state_dict(harness.load_params_for_eval(pc, path))
        params = reference_state_dict_to_params(sd, jc.model)
        rng = np.random.default_rng(9)
        x = rng.normal(size=(2, pc.model.temporal_seq_len, pc.model.num_nodes, 6)).astype(np.float32)
        tf = np.stack([rng.integers(0, v, size=(2, x.shape[1])) for v in (12, 366, 13, 4)], axis=-1).astype(np.int32)
        valid = np.asarray(graph.stencil_valid)
        want = np.asarray(JaxTECMoLLM(jc.model, stencil_shifts=shifts).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(tf), jnp.asarray(valid), jnp.asarray(valid),
            deterministic=True,
        ))
        _, g = graph_inputs(graph, "cpu")
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x), torch.from_numpy(tf), *g).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(load_reference_checkpoint(path, pc.model)["prediction_head.mlp.0.bias"],
                           sd["prediction_head.mlp.0.bias"])

    def test_port_checkpoint_is_its_own_state_dict(self, tmp_path):
        cfg = tiny()
        path = save_run(tmp_path, "r", cfg, 4)
        saved = torch.load(path, weights_only=True)
        loaded = harness.load_params_for_eval(cfg, path)
        assert set(loaded) == set(saved) and all(torch.equal(loaded[k], saved[k]) for k in saved)

    def test_refusals(self, tmp_path):
        cfg = tiny()
        sd = make_fake_reference_state_dict(jcfg.tiny_config().model)
        with pytest.raises(ValueError, match="node table has 48 rows < num_nodes 60"):
            reference_state_dict_to_port(sd, dataclasses.replace(cfg.model, num_nodes=60))
        path = save_run(tmp_path, "r", cfg, 0)
        with pytest.raises(RuntimeError, match="does not match the model built from the current config"):
            harness.load_params_for_eval(tiny(quantiles=LEVELS), path)


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    return write_eval_dir(str(tmp_path_factory.mktemp("eval") / "proc"), tiny())


class TestHarness:
    def test_streaming_agrees_with_materialized_predictions(self, eval_dir, tmp_path):
        """The model's and the HA's streamed metrics against evaluate_horizons
        of the materialized predictions: rtol 1e-5 for fp32 sums of a batch,
        and atol 1e-6 for the random model's Pearson r near 0, which the sums
        give through differences that cancel."""
        from tec_mollm_tpu_torch.data import SlidingWindowDataset

        cfg = tiny()
        state = harness.load_params_for_eval(cfg, save_run(tmp_path, "r", cfg, 3))
        ds = SlidingWindowDataset.from_dir(eval_dir, "test", cfg.train.L_in, cfg.train.L_out)
        graph = GraphData.load(os.path.join(eval_dir, "graph.npz"))
        trues, preds = harness.get_model_predictions(cfg, state, ds, graph, batch_size=8, device="cpu")
        np.testing.assert_array_equal(trues, harness.host_targets(ds))
        streamed = harness.evaluate_model_streaming(cfg, state, ds, graph, SCALER, 8, device="cpu")
        _assert_dicts_close(streamed, pmetrics.evaluate_horizons(trues, preds, SCALER), rtol=1e-5, atol=1e-6)
        ha = harness.evaluate_baseline_streaming(ds, cfg.train.L_out, SCALER, device="cpu")
        want = pmetrics.evaluate_horizons(trues, harness.get_baseline_predictions(ds, cfg.train.L_out), SCALER)
        _assert_dicts_close(ha, want, rtol=1e-5)


class TestCLIs:
    def test_test_cli_on_the_cpu(self, eval_dir, tmp_path):
        """Point model: both rows finite, rollout_results.csv; 'latest' picks
        the run's config.json."""
        save_run(tmp_path, "p", tiny(), 0)
        out_dir = str(tmp_path / "res")
        out = test_cli.main(["--cpu", "--data-dir", eval_dir, "--workdir", str(tmp_path), "--output-dir", out_dir,
                             "--rollout-steps", "6", "--rollout-windows", "3"])
        rows = open(os.path.join(out_dir, "evaluation_results.csv")).read().splitlines()
        assert [r.split(",")[0] for r in rows] == ["model", "TEC-MoLLM", "HistoricalAverage"]
        assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(",")[1:])
        assert len(rows[0].split(",")) == 1 + 4 + 4 * 4
        steps = open(os.path.join(out_dir, "rollout_results.csv")).read().splitlines()
        assert steps[0] == "step,mae,rmse" and len(steps) == 7
        assert out["rollout"]["num_windows"] == 3

    def test_predict_cli_on_the_cpu(self, eval_dir, tmp_path):
        """Quantile + RevIN: fit conformal offsets on val, then predict writes
        the calibrated bands."""
        quant = tiny(revin=True, quantiles=LEVELS)
        path = save_run(tmp_path, "q", quant, 2)
        test_cli.main(["--cpu", "--data-dir", eval_dir, "--workdir", str(tmp_path), "--split", "val",
                       "--conformal", "fit", "--output-dir", str(tmp_path / "fit")])
        assert os.path.exists(pconf.ConformalOffsets.path_for(path))
        out_dir = str(tmp_path / "pred")
        out = predict_cli.main(["--cpu", "--data-dir", eval_dir, "--workdir", str(tmp_path), "--indices", "0", "5",
                                "--output-dir", out_dir])
        with np.load(os.path.join(out_dir, "forecast.npz")) as f:
            assert set(f.files) == {"indices", "forecast", "truth", "forecast_quantiles", "quantile_levels",
                                    "forecast_quantiles_conformal", "conformal_offsets"}
            assert f["forecast_quantiles_conformal"].shape == (2, quant.train.L_out, quant.model.num_nodes, 3)
            np.testing.assert_array_equal(f["indices"], [0, 5])
        assert out["mae"] > 0

    def test_sarima_is_refused_before_loading(self, eval_dir, tmp_path):
        """Ported: --baseline sarima is no longer refused by the parser (a
        missing checkpoint now fails at its load), and the CLI writes a finite
        SARIMA row beside the HA's; a season the windows cannot condition is
        refused with the JAX package's message. (The row against JAX's is
        tests/test_torch_sarima_jax.py.)"""
        with pytest.raises(FileNotFoundError):
            test_cli.main(["--cpu", "--data-dir", eval_dir, "--baseline", "sarima",
                           "--checkpoint", str(tmp_path / "missing.pt")])
        save_run(tmp_path, "s", tiny(), 0)
        out_dir = str(tmp_path / "out")
        args = ["--cpu", "--data-dir", eval_dir, "--workdir", str(tmp_path), "--baseline", "sarima",
                "--output-dir", out_dir]
        out = test_cli.main(args + ["--sarima-season", "4"])
        rows = open(os.path.join(out_dir, "evaluation_results.csv")).read().splitlines()
        assert [r.split(",")[0] for r in rows[1:]] == ["TEC-MoLLM", "HistoricalAverage", "SARIMA"]
        assert all(np.isfinite(float(v)) for v in rows[3].split(",")[1:])
        assert "SARIMA:" in open(os.path.join(out_dir, "evaluation_summary.txt")).read()
        assert out["results"]["SARIMA"]["mae_avg"] > 0
        with pytest.raises(ValueError, match="L_in=16 too short"):
            test_cli.main(args + ["--sarima-season", "12"])

    @pytest.mark.parametrize("cli", ["test", "predict"])
    def test_no_cuda_without_cpu_raises(self, cli, eval_dir, tmp_path, monkeypatch):
        save_run(tmp_path, "p", tiny(), 0)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        main = {"test": test_cli.main, "predict": predict_cli.main}[cli]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--data-dir", eval_dir, "--workdir", str(tmp_path), "--output-dir", str(tmp_path / "o")])
        assert not os.path.exists(tmp_path / "o")
