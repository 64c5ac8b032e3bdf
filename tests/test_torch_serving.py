"""PyTorch port: ForecastService against the JAX ForecastService.

Both serve the same processed tiny dir with the same weights (the JAX side
restores them from an orbax checkpoint, as tests/test_serving.py builds it; the
port takes them through models/convert.py), in fp32 (bf16=False). Forecasts
are compared in TECU: fp32 sums in another order move them by ~1e-5 scaled
units, i.e. well under 1e-3 TECU at the synthetic target scale."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu_torch.config as pcfg
from tec_mollm_tpu_torch.device import resolve_device
from tec_mollm_tpu_torch.models import params_to_state_dict
from tec_mollm_tpu_torch.serving import ForecastService, make_server


def _fp32(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=False))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from tec_mollm_tpu.data.preprocess import run_preprocess
    from tec_mollm_tpu.graph.builder import GraphData
    from tec_mollm_tpu.models import TECMoLLM
    from tec_mollm_tpu.models.tec_mollm import graph_inputs
    from tec_mollm_tpu.training.checkpoint import CheckpointManager

    wd = tmp_path_factory.mktemp("torch_serve")
    data_dir = wd / "proc"
    jc = _fp32(jcfg.tiny_config())
    run_preprocess(
        jcfg.DataConfig(horizon=jc.train.L_out), str(data_dir),
        synthetic_steps=200, synthetic_grid=(jc.model.grid_h, jc.model.grid_w),
    )
    graph = GraphData.load(str(data_dir / "graph.npz"))
    m = jc.model
    shifts, (valid, _) = graph_inputs(graph)
    params = TECMoLLM(m, stencil_shifts=shifts).init(
        jax.random.key(0),
        jnp.zeros((1, m.temporal_seq_len, m.num_nodes, m.in_features)),
        jnp.zeros((1, m.temporal_seq_len, 4), jnp.int32), valid, valid,
    )["params"]
    rng = np.random.default_rng(0)
    flat = {
        k: (np.asarray(v) + 0.05 * rng.normal(size=np.shape(v))).astype(np.float32)
        for k, v in flatten_dict(jax.device_get(params), sep="/").items()
    }
    CheckpointManager(str(wd), "srun").save_params(unflatten_dict(flat, sep="/"), "best")
    (wd / "checkpoints" / "srun" / "config.json").write_text(jc.to_json())
    pc = _fp32(pcfg.tiny_config())
    sd = params_to_state_dict(flat, pc.model)
    return {"wd": str(wd), "data_dir": str(data_dir), "jc": jc, "pc": pc, "sd": sd}


@pytest.fixture(scope="module")
def port_service(served):
    svc = ForecastService(served["pc"], served["data_dir"], state_dict=served["sd"], device="cpu")
    yield svc
    svc.close()


class TestAgainstJax:
    def test_forecasts_match_the_jax_service(self, served, port_service):
        from tec_mollm_tpu.serving import ForecastService as JaxService

        jax_svc = JaxService(
            served["jc"], served["data_dir"], "latest", workdir=served["wd"], run_name="srun",
            max_batch=8, batch_window_ms=0,
        )
        idx = [0, 2, 4, 6]
        want = np.asarray(jax_svc.forecast(idx)["forecast"])
        got = np.asarray(port_service.forecast(idx)["forecast"])
        assert got.shape == want.shape == (4, served["pc"].train.L_out, served["pc"].model.num_nodes)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        assert np.ptp(got) > 1e-2  # the comparison is not between two constants


class TestService:
    def test_units_clip_and_shapes(self, served, port_service):
        out = port_service.forecast([0, 1])
        f = np.asarray(out["forecast"])
        assert f.shape == (2, served["pc"].train.L_out, served["pc"].model.num_nodes)
        assert np.isfinite(f).all() and (f >= 0).all() and (f <= 200).all()
        assert out["indices"] == [0, 1] and out["latency_ms"] > 0

    def test_padding_does_not_change_results(self, port_service):
        solo = np.asarray(port_service.forecast([2])["forecast"])
        batch = np.asarray(port_service.forecast([0, 1, 2, 3])["forecast"])
        np.testing.assert_allclose(solo[0], batch[2], rtol=1e-5, atol=1e-5)

    def test_request_validation(self, port_service):
        with pytest.raises(ValueError, match="out of range"):
            port_service.forecast([10**6])
        with pytest.raises(ValueError, match="1..8"):
            port_service.forecast([])
        with pytest.raises(ValueError, match="1..8"):
            port_service.forecast(list(range(9)))
        with pytest.raises(KeyError, match="not served"):
            port_service.forecast([0], split="val")

    def test_concurrent_requests_coalesce_and_match_serial(self, port_service):
        idxs = [[i] for i in range(6)]
        results = [None] * len(idxs)

        def call(i):
            results[i] = np.asarray(port_service.forecast(idxs[i])["forecast"])

        before = port_service.stats().get("batches", 0)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(idxs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        serial = np.asarray(port_service.forecast(list(range(6)))["forecast"])
        for i in range(6):
            np.testing.assert_allclose(results[i][0], serial[i], rtol=1e-5, atol=1e-5)
        assert port_service.stats()["batches"] - before <= 7

    def test_http_endpoints(self, port_service):
        httpd = make_server(port_service, "127.0.0.1", 0)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{port}"
        try:
            health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
            assert health["status"] == "ok" and health["device"] == "cpu"
            req = urllib.request.Request(f"{base}/forecast", data=json.dumps({"indices": [1]}).encode(), method="POST")
            out = json.loads(urllib.request.urlopen(req, timeout=60).read())
            assert np.asarray(out["forecast"]).shape[0] == 1
            stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
            assert stats["requests"] >= 1 and "p50_ms" in stats
            metrics = urllib.request.urlopen(f"{base}/metrics", timeout=60).read().decode()
            assert "tec_mollm_requests_total" in metrics
            bad = urllib.request.Request(f"{base}/forecast", data=b'{"indices": []}', method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=60)
            assert e.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/nope", timeout=60)
            assert e.value.code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_checkpoint_file_and_cli_bench(self, served, tmp_path, capsys):
        from tec_mollm_tpu_torch.serve import main

        ckpt = tmp_path / "model.pt"
        torch.save(served["sd"], ckpt)
        (tmp_path / "config.json").write_text(served["pc"].to_json())
        main(["--data-dir", served["data_dir"], "--checkpoint", str(ckpt), "--bench", "3", "--cpu"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["requests"] == 3 and out["device"] == "cpu" and out["p50_ms"] > 0

    def test_quantile_model_serves_levels(self, served):
        pc = served["pc"]
        pc = dataclasses.replace(pc, model=dataclasses.replace(pc.model, quantiles=(0.1, 0.5, 0.9)))
        from tec_mollm_tpu_torch.graph import GraphData
        from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs

        graph = GraphData.load(f"{served['data_dir']}/graph.npz")
        shifts, _ = graph_inputs(graph, "cpu")
        sd = TECMoLLM(pc.model, shifts, seed=1).state_dict()
        svc = ForecastService(pc, served["data_dir"], state_dict=sd, device="cpu", batch_window_ms=0)
        out = svc.forecast([0])
        q = np.asarray(out["forecast_quantiles"])
        assert out["quantile_levels"] == [0.1, 0.5, 0.9] and q.shape[-1] == 3
        np.testing.assert_array_equal(np.asarray(out["forecast"]), q[..., 1])


class TestDevice:
    def test_entry_points_need_cuda_unless_cpu_is_asked(self, served, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ForecastService(served["pc"], served["data_dir"], state_dict=served["sd"])
        assert resolve_device("cpu") == torch.device("cpu")

    def test_exactly_one_weight_source(self, served):
        with pytest.raises(ValueError, match="exactly one"):
            ForecastService(served["pc"], served["data_dir"], device="cpu")
