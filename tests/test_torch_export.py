"""PyTorch port: export of the forecast forward (``serving/export.py``), the
export CLI and serving an artifact (``ForecastService(artifact=...)``,
``serve --artifact``), on the CPU with the tiny config in fp32 (the JAX side
of the parity is tests/test_torch_export_jax.py).

* a symbolic-batch artifact serves B = 3 and B = 1 within 1e-5 of the eager
  forward of the same weights (the same plain arithmetic: the ops' CPU
  implementations are the kernels' plain versions); a fixed-batch artifact
  refuses any other batch;
* the artifact holds the forward kernels as op nodes: a stencil graph one
  ``tec_mollm.gat_stencil`` and no ``aten.roll``, a fused config one
  ``short_attention`` and one ``fused_ln_mlp`` per GPT-2 block, a graph
  without a stencil the plain gather and no GAT op;
* the service cross-checks the metadata (a ``ValueError`` names the
  mismatch), takes a fixed batch as its ``max_batch``, refuses a device the
  artifact was not exported for, and serves the checkpoint service's
  forecasts (and calibrated bands) within 1e-5 TECU; the serve CLI runs on
  it."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_eval import LEVELS, save_run, tiny, write_eval_dir

from tec_mollm_tpu_torch import export as export_cli
from tec_mollm_tpu_torch import serve as serve_cli
from tec_mollm_tpu_torch.evaluation.conformal import ConformalOffsets
from tec_mollm_tpu_torch.graph import GraphData
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs
from tec_mollm_tpu_torch.serving import ForecastService
from tec_mollm_tpu_torch.serving import export as ex
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FUSED = dict(fused_attn=True, use_fused_mlp=True)


@pytest.fixture(scope="module")
def proc(tmp_path_factory):
    return write_eval_dir(str(tmp_path_factory.mktemp("export") / "proc"), tiny())


@pytest.fixture(scope="module")
def run(proc, tmp_path_factory):
    """(config, checkpoint path, state_dict, graph) of a seeded point run."""
    wd = tmp_path_factory.mktemp("export_wd")
    cfg = tiny()
    ckpt = save_run(wd, "point", cfg, seed=3)
    sd = torch.load(ckpt, weights_only=True)
    return cfg, ckpt, sd, GraphData.load(os.path.join(proc, "graph.npz"))


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cfg.train.L_in, cfg.model.num_nodes, cfg.model.in_features)).astype(np.float32)
    tf = rng.integers(0, 4, size=(b, cfg.train.L_in, 4)).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(tf)


def _eager(cfg, sd, graph, x, tf, **flags):
    shifts, pair = graph_inputs(graph, "cpu")
    model = TECMoLLM(cfg.model, shifts, seed=None, **flags)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval()(x, tf, *pair)


class TestExport:
    @pytest.mark.parametrize("flags", [{}, FUSED], ids=["default", "fused"])
    def test_symbolic_batch_matches_eager(self, run, tmp_path, flags):
        cfg, _, sd, graph = run
        ep = ex.export_forecaster(cfg, sd, graph, platforms=("cpu",), **flags)
        path = str(tmp_path / "m.pt2")
        ex.save_exported(ep, path)
        fn = ex.load_forecaster(path, "cpu")
        for b in (3, 1):
            x, tf = _inputs(cfg, b, seed=b)
            got = fn(x, tf)
            assert got.shape == (b, cfg.train.L_out, cfg.model.num_nodes, 1)
            torch.testing.assert_close(got, _eager(cfg, sd, graph, x, tf, **flags), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("flags, blocks", [({}, 0), (FUSED, 1)], ids=["default", "fused"])
    def test_graph_holds_the_kernel_ops(self, run, flags, blocks):
        """One GAT node and no roll; one attention and one MLP node per GPT-2
        block in a fused artifact, none otherwise."""
        cfg, _, sd, graph = run
        ops = ex.artifact_ops(ex.export_forecaster(cfg, sd, graph, platforms=("cpu",), **flags))
        layers = cfg.model.llm_layers
        assert ops.get("tec_mollm.gat_stencil") == 1
        assert "aten.roll" not in ops
        assert ops.get("tec_mollm.short_attention", 0) == blocks * layers
        assert ops.get("tec_mollm.fused_ln_mlp", 0) == blocks * layers

    def test_padded_gather_graph_exports_the_plain_gather(self, run):
        cfg, _, sd, graph = run
        padded = dataclasses.replace(graph, stencil_shifts=None, stencil_valid=None)
        ep = ex.export_forecaster(cfg, sd, padded, platforms=("cpu",))
        ops = ex.artifact_ops(ep)
        assert "tec_mollm.gat_stencil" not in ops and ops.get("aten.index_select") == 1
        x, tf = _inputs(cfg, 2, seed=7)
        torch.testing.assert_close(ep.module()(x, tf), _eager(cfg, sd, padded, x, tf), rtol=0, atol=1e-5)
        assert ex.artifact_meta(cfg, padded, "c", ("cpu",))["gat_route"].startswith("plain")

    def test_fixed_batch_refuses_another(self, run):
        cfg, _, sd, graph = run
        fn = ex.export_forecaster(cfg, sd, graph, batch_size=2, platforms=("cpu",)).module()
        assert fn(*_inputs(cfg, 2, seed=0)).shape[0] == 2
        with pytest.raises((AssertionError, RuntimeError, ValueError)):
            fn(*_inputs(cfg, 1, seed=0))

    def test_platforms(self, run):
        cfg, _, sd, graph = run
        assert ex.check_platforms(["cuda", "cpu"]) == ("cuda", "cpu")
        for bad, match in ((("tpu", "cpu"), "JAX package"), (("gpu",), "unknown"), ((), "at least one")):
            with pytest.raises(ValueError, match=match):
                ex.export_forecaster(cfg, sd, graph, platforms=bad)
        with pytest.raises(SystemExit, match="leaves out"):
            export_cli.main(["--cpu", "--platforms", "cuda"])

    def test_metadata_is_written_before_the_program(self, run, tmp_path, monkeypatch):
        """A crash while the program is written leaves the metadata and no
        program: an artifact on disk always has its cross-checks."""
        cfg, ckpt, sd, graph = run
        ep = ex.export_forecaster(cfg, sd, graph, platforms=("cpu",))
        path = str(tmp_path / "m.pt2")

        def crash(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(torch.export, "save", crash)
        with pytest.raises(OSError, match="disk full"):
            ex.save_exported(ep, path, meta=ex.artifact_meta(cfg, graph, ckpt, ("cpu",)))
        assert os.path.exists(path + ".json") and not os.path.exists(path)
        assert sorted(os.listdir(tmp_path)) == ["m.pt2.json", os.path.basename(path) + f".tmp{os.getpid()}"]

    def test_loading_needs_no_model_code(self, run, tmp_path):
        """A fresh interpreter with the model package blocked loads the
        artifact and computes the same forecasts."""
        cfg, _, sd, graph = run
        path = str(tmp_path / "m.pt2")
        ex.save_exported(ex.export_forecaster(cfg, sd, graph, platforms=("cpu",)), path)
        x, tf = _inputs(cfg, 2, seed=11)
        torch.save({"x": x, "tf": tf, "want": _eager(cfg, sd, graph, x, tf)}, tmp_path / "io.pt")
        code = textwrap.dedent(f"""
            import sys, torch
            for name in ("jax", "tec_mollm_tpu", "tec_mollm_tpu_torch.models", "tec_mollm_tpu_torch.serving.server"):
                sys.modules[name] = None
            from tec_mollm_tpu_torch.serving.export import load_forecaster
            io = torch.load({str(tmp_path / "io.pt")!r})
            got = load_forecaster({path!r}, "cpu")(io["x"], io["tf"])
            torch.testing.assert_close(got, io["want"], rtol=0, atol=1e-5)
            assert not [m for m, mod in sys.modules.items() if m.startswith("tec_mollm_tpu_torch.models") and mod]
        """)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]


def _export(proc, ckpt, out, *extra):
    return export_cli.main(["--cpu", "--data-dir", proc, "--checkpoint", ckpt, "--out", str(out), *extra])


class TestService:
    @pytest.mark.parametrize("batch", [None, 2])
    def test_artifact_serves_the_checkpoint_forecasts(self, proc, run, tmp_path, batch):
        """The export CLI's artifact (symbolic, or a fixed batch of 2 that
        overrides max_batch 8) against the checkpoint service: forecasts
        within 1e-5 TECU; stats and health say where the forward comes from."""
        cfg, ckpt, _, _ = run
        extra = [] if batch is None else ["--batch-size", str(batch)]
        path = _export(proc, ckpt, tmp_path / "m.pt2", *extra)
        meta = json.loads(Path(path + ".json").read_text())
        assert meta == {
            "checkpoint": ckpt, "platforms": ["cpu"], "batch": batch or "symbolic", "L_in": cfg.train.L_in,
            "L_out": cfg.train.L_out, "num_nodes": cfg.model.num_nodes, "in_features": 6, "dtype": "float32",
            "gat_route": "kernel",
        }
        art = ForecastService(cfg, proc, artifact=path, device="cpu", batch_window_ms=0)
        svc = ForecastService(cfg, proc, checkpoint=ckpt, device="cpu", batch_window_ms=0)
        try:
            assert art.max_batch == (batch or 8)
            for idx in ([0], [3, 5][: art.max_batch]):
                got, want = art.forecast(idx), svc.forecast(idx)
                np.testing.assert_allclose(got["forecast"], want["forecast"], rtol=0, atol=1e-5)
            stats, health = art.stats(), art.health()
            assert stats["source"] == health["source"] == "artifact" and svc.stats()["source"] == "checkpoint"
            assert stats["gat_route"] == health["gat_route"] == "kernel" and health["checkpoint"] == path
        finally:
            art.close()
            svc.close()

    def test_metadata_mismatches_and_platforms_are_refused(self, proc, run, tmp_path):
        cfg, ckpt, _, _ = run
        path = _export(proc, ckpt, tmp_path / "m.pt2")
        other = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, L_out=3))
        with pytest.raises(ValueError, match="L_out"):
            ForecastService(other, proc, artifact=path, device="cpu")
        meta_path = Path(path + ".json")
        meta = json.loads(meta_path.read_text())
        meta_path.write_text(json.dumps({**meta, "num_nodes": 49}))
        with pytest.raises(ValueError, match="num_nodes"):
            ForecastService(cfg, proc, artifact=path, device="cpu")
        meta_path.write_text(json.dumps({**meta, "platforms": ["cuda"]}))
        with pytest.raises(ValueError, match="exported for"):
            ForecastService(cfg, proc, artifact=path, device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            ForecastService(cfg, proc, checkpoint=ckpt, artifact=path, device="cpu")

    def test_no_metadata_takes_the_config_dtype(self, proc, run, tmp_path):
        cfg, ckpt, _, _ = run
        path = _export(proc, ckpt, tmp_path / "m.pt2")
        os.remove(path + ".json")
        svc = ForecastService(cfg, proc, artifact=path, device="cpu", batch_window_ms=0)
        try:
            assert svc.dtype == torch.float32 and len(svc.forecast([1])["forecast"]) == 1
        finally:
            svc.close()

    def test_conformal_offsets_beside_the_artifact(self, proc, tmp_path):
        """A quantile artifact serves bands calibrated by the conformal.npz
        beside it, as the checkpoint service does beside its checkpoint."""
        cfg = tiny(revin=True, quantiles=LEVELS)
        ckpt = save_run(tmp_path, "quant", cfg, seed=5)
        out = tmp_path / "exports"
        path = _export(proc, ckpt, out / "q.pt2")
        offsets = ConformalOffsets(LEVELS, np.linspace(-1.0, 1.0, cfg.train.L_out * 3).reshape(cfg.train.L_out, 3))
        for where in (ckpt, path):
            offsets.save(ConformalOffsets.path_for(where))
        art = ForecastService(cfg, proc, artifact=path, device="cpu", batch_window_ms=0)
        svc = ForecastService(cfg, proc, checkpoint=ckpt, device="cpu", batch_window_ms=0)
        try:
            got, want = art.forecast([2]), svc.forecast([2])
            for k in ("forecast_quantiles", "forecast_quantiles_conformal"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        finally:
            art.close()
            svc.close()

    def test_serve_cli_bench_on_an_artifact(self, proc, run, tmp_path, capsys):
        cfg, ckpt, _, _ = run
        path = _export(proc, ckpt, tmp_path / "m.pt2")
        capsys.readouterr()
        serve_cli.main(["--cpu", "--data-dir", proc, "--checkpoint", ckpt, "--artifact", path, "--bench", "2"])
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["requests"] == 2 and stats["source"] == "artifact" and stats["device"] == "cpu"
