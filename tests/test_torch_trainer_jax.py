"""PyTorch port: its Trainer against the JAX Trainer.

The same weights (the port's initial state_dict through the reference
importer), data and config; 2 epochs with shuffling, every dropout 0, fp32.
Per-epoch train and val losses within 1e-5 relative, the validation MAE and
RMSE per horizon within 1e-4 relative, the same best epoch. A file of its own,
so that the workers run it beside the port's other trainer tests. The JAX
Trainer's parameter init is jitted here (its eager init takes most of a
minute on a loaded CPU); the weights it draws are replaced by the port's."""

import os
import types

import jax
import numpy as np
import pytest
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
    create = jax_trainer_module.create_train_state

    def with_jitted_init(model, *args, **kwargs):
        return create(types.SimpleNamespace(init=jax.jit(model.init)), *args, **kwargs)

    monkeypatch.setattr(jax_trainer_module, "create_train_state", with_jitted_init)


def test_trainer_matches_the_jax_trainer(tmp_path, jitted_init):
    pc, jc = _cfg(dropout=False, lr=1e-3), _cfg(jcfg, dropout=False, lr=1e-3)
    proc = _write_processed(str(tmp_path / "proc"), pc)
    port = _trainer(pc, proc, tmp_path / "port")
    t = jc.train
    jds = {m: JaxDataset.from_dir(proc, m, t.L_in, t.L_out, stride=1) for m in ("train", "val")}
    jgraph = JaxGraphData.load(os.path.join(proc, "graph.npz"))
    mesh = make_mesh(data_parallel=1, model_parallel=1, devices=jax.devices()[:1])
    jt = jax_trainer_module.Trainer(
        jc, jds["train"], jds["val"], jgraph, port.target_scaler, workdir=str(tmp_path / "jax"),
        run_name="run", mesh=mesh,
    )
    # copies: JAX may alias a numpy buffer, and the port trains its tensors in place
    sd = {k: v.numpy().copy() for k, v in port.model.state_dict().items()}
    jt.set_params(reference_state_dict_to_params(sd, jc.model))

    got, want = port.fit(), jt.fit()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["updates"] == w["updates"] == 4
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-5)
        assert g["val_loss"] == pytest.approx(w["val_loss"], rel=1e-5)
    assert int(np.argmin([r["val_loss"] for r in got])) == int(np.argmin([r["val_loss"] for r in want]))
    (_, pm), (_, jm) = port.validate(), jt.validate()
    for k in ("mae_by_horizon", "rmse_by_horizon"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
