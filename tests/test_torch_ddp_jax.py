"""PyTorch port: its 2-rank data-parallel Trainer against the JAX Trainer on
a dp=2 mesh.

The same config (fp32, every dropout 0, shuffled, batch 1 a replica x 2
microbatches, so macro batches of 4), the same weights (the port's initial
state_dict through the reference importer), the same data, 2 epochs. The
port's ranks are gloo processes of tests/torch_ddp_worker.py, which import
nothing of JAX; the JAX Trainer runs here on two of the virtual CPU devices.
Per-epoch train and val losses within 1e-5 relative, the same updates and
the same best epoch. A file of its own, so that the workers run it beside the
port's other DDP tests."""

import os
import types

import jax
import numpy as np
import pytest
from test_torch_ddp import WINDOWS, ddp_cfg, run_ranks
from test_torch_trainer import _cfg, _trainer, _write_processed

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu.training.trainer as jax_trainer_module
from tec_mollm_tpu.data.dataset import SlidingWindowDataset as JaxDataset
from tec_mollm_tpu.graph.builder import GraphData as JaxGraphData
from tec_mollm_tpu.models.ref_import import reference_state_dict_to_params
from tec_mollm_tpu.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def jitted_init(monkeypatch):
    """The JAX Trainer's parameter init, jitted (its eager init takes most of
    a minute on a loaded CPU); the weights it draws are replaced below."""
    create = jax_trainer_module.create_train_state

    def with_jitted_init(model, *args, **kwargs):
        return create(types.SimpleNamespace(init=jax.jit(model.init)), *args, **kwargs)

    monkeypatch.setattr(jax_trainer_module, "create_train_state", with_jitted_init)


def test_two_ranks_match_the_jax_trainer_on_a_dp2_mesh(tmp_path, jitted_init):
    pc = ddp_cfg(1)
    jc = _cfg(jcfg, dropout=False, lr=1e-3, batch_size=1, accumulation_steps=2, train_stride=1)
    proc = _write_processed(str(tmp_path / "proc"), pc, windows=WINDOWS)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(pc.to_json())
    records = run_ranks(str(tmp_path), "fit", {"kind": "fit", "config": cfg_path, "data": proc,
                                               "workdir": str(tmp_path / "port")})

    # the weights every rank starts from: the seeded init of the port's model
    sd = {k: v.numpy().copy() for k, v in _trainer(pc, proc, tmp_path / "init").model.state_dict().items()}
    t = jc.train
    jds = {m: JaxDataset.from_dir(proc, m, t.L_in, t.L_out, stride=1) for m in ("train", "val")}
    mesh = make_mesh(data_parallel=2, model_parallel=1, devices=jax.devices()[:2])
    jt = jax_trainer_module.Trainer(
        jc, jds["train"], jds["val"], JaxGraphData.load(os.path.join(proc, "graph.npz")),
        _trainer(pc, proc, tmp_path / "init").target_scaler, workdir=str(tmp_path / "jax"), run_name="run",
        mesh=mesh,
    )
    assert jt.dp == 2 and jt.macro_batch == 4
    jt.set_params(reference_state_dict_to_params(sd, jc.model))
    want = jt.fit()

    assert len(want) == 2
    for rec in records:
        got = rec["history"]
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g["updates"] == w["updates"] == 4
            assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5)
            assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5)
        assert int(np.argmin([r["val_loss"] for r in got])) == int(np.argmin([r["val_loss"] for r in want]))
