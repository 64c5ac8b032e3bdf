"""PyTorch port: its tensor parallelism against the JAX package's.

* ``param_split`` against JAX's ``param_pspecs`` for every parameter of the
  tiny model (the reference names mapped to Flax paths through the JAX
  package's reference importer), at mp 2, 3 and 4: 3 leaves the MLP and the
  head whole (256 and 128 do not divide by 3), JAX's indivisible-dimension
  fallback; and the rules of tests/test_distributed.py on a hand-made tree.
* The port at dp 2 x mp 2 (4 gloo processes of tests/torch_ddp_worker.py,
  which import nothing of JAX) against the JAX ``Trainer`` on a
  ``make_mesh(data_parallel=2, model_parallel=2)`` mesh of 4 of the virtual
  CPU devices: the same config (fp32, every dropout 0, shuffled, batch 1 a
  replica x 2 microbatches), the same weights (the port's seeded init
  through the reference importer), the same data, 2 epochs; per-epoch train
  and val losses within 2e-4 relative (JAX's own tp bound), the same updates
  and best epoch."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from test_torch_ddp import WINDOWS, ddp_cfg, run_ranks
from test_torch_ddp_jax import jitted_init  # noqa: F401 (fixture)
from test_torch_trainer import _cfg, _trainer, _write_processed

import tec_mollm_tpu.config as jcfg
import tec_mollm_tpu.training.trainer as jax_trainer_module
from tec_mollm_tpu.data.dataset import SlidingWindowDataset as JaxDataset
from tec_mollm_tpu.graph.builder import GraphData as JaxGraphData
from tec_mollm_tpu.models.ref_import import reference_state_dict_to_params
from tec_mollm_tpu.parallel.mesh import make_mesh
from tec_mollm_tpu.parallel.partitioning import param_pspecs
from tec_mollm_tpu_torch.config import tiny_config
from tec_mollm_tpu_torch.models import TECMoLLM
from tec_mollm_tpu_torch.parallel.partitioning import param_split
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _kind(spec: P) -> str:
    """JAX's spec as the port's kind: a split on the last axis is a column
    split (kernel (in, out), bias, lora_B (r, out)), on the first a row split."""
    if spec == P():
        return "replicated"
    return "column" if spec[-1] == "model" else "row"


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_param_split_is_jax_param_pspecs(mp):
    cfg = tiny_config().model
    sd = TECMoLLM(cfg, seed=0).state_dict()
    names = sorted(sd)
    # every tensor filled with its own index: the importer's transposes and
    # reshapes keep it, so each Flax leaf names its state_dict entry
    marked = {n: np.full(tuple(sd[n].shape), float(i), np.float32) for i, n in enumerate(names)}
    params = reference_state_dict_to_params(marked, jcfg.tiny_config().model)
    leaves = jax.tree_util.tree_leaves(params)
    specs = jax.tree_util.tree_leaves(param_pspecs(params, mp), is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs)
    seen = set()
    for leaf, spec in zip(leaves, specs):
        values = np.unique(np.asarray(leaf))
        assert len(values) == 1, values
        name = names[int(values[0])]
        seen.add(name)
        assert param_split(name, tuple(sd[name].shape), mp) == _kind(spec), (name, spec)
    assert seen == set(names)


def test_pspec_rules_on_the_jax_tests_tree():
    """tests/test_distributed.py:101-130, by state_dict name and torch shape."""
    split = {
        "llm_backbone.model.h.0.attn.c_attn.weight": ((64, 192), "column"),
        "llm_backbone.model.h.0.attn.c_proj.weight": ((64, 64), "row"),
        "llm_backbone.model.h.0.mlp.c_fc.weight": ((64, 256), "column"),
        "llm_backbone.model.h.0.mlp.c_proj.weight": ((256, 64), "row"),
        "prediction_head.mlp.0.weight": ((128, 256), "column"),
        "prediction_head.mlp.3.weight": ((4, 128), "row"),
        "spatio_temporal_embedding.node_embedding.weight": ((48, 16), "replicated"),
        "llm_backbone.model.h.0.ln_1.weight": ((64,), "replicated"),
        "llm_backbone.model.h.0.attn.c_attn.lora_B.weight": ((192, 4), "column"),
    }
    for name, (shape, kind) in split.items():
        assert param_split(name, shape, 2) == kind, name
    want = param_pspecs({"llm": {"h_0": {"attn": {"c_attn": {"kernel": jnp.zeros((4, 9))}}}}}, model_parallel=2)
    assert want["llm"]["h_0"]["attn"]["c_attn"]["kernel"] == P()
    assert param_split("llm_backbone.model.h.0.attn.c_attn.weight", (4, 9), 2) == "replicated"


def test_dp2_mp2_ranks_match_the_jax_trainer_on_a_dp2_tp2_mesh(tmp_path, jitted_init):  # noqa: F811
    pc = ddp_cfg(1)
    jc = _cfg(jcfg, dropout=False, lr=1e-3, batch_size=1, accumulation_steps=2, train_stride=1, model_parallel=2)
    proc = _write_processed(str(tmp_path / "proc"), pc, windows=WINDOWS)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(pc.to_json())
    records = run_ranks(str(tmp_path), "fit", {"kind": "fit", "config": cfg_path, "data": proc, "model_parallel": 2,
                                               "workdir": str(tmp_path / "port")}, world=4)

    # the weights every rank starts from: the seeded init of the port's model
    init = _trainer(pc, proc, tmp_path / "init")
    sd = {k: v.numpy().copy() for k, v in init.model.state_dict().items()}
    t = jc.train
    jds = {m: JaxDataset.from_dir(proc, m, t.L_in, t.L_out, stride=1) for m in ("train", "val")}
    mesh = make_mesh(data_parallel=2, model_parallel=2, devices=jax.devices()[:4])
    jt = jax_trainer_module.Trainer(
        jc, jds["train"], jds["val"], JaxGraphData.load(os.path.join(proc, "graph.npz")), init.target_scaler,
        workdir=str(tmp_path / "jax"), run_name="run", mesh=mesh,
    )
    assert jt.dp == 2 and jt.macro_batch == 4
    jt.set_params(reference_state_dict_to_params(sd, jc.model))
    want = jt.fit()

    assert len(want) == 2 and len(records) == 4
    for rec in records:
        got = rec["history"]
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g["updates"] == w["updates"] == 4
            assert g["train_loss"] == pytest.approx(w["train_loss"], rel=2e-4)
            assert g["val_loss"] == pytest.approx(w["val_loss"], rel=2e-4)
        assert int(np.argmin([r["val_loss"] for r in got])) == int(np.argmin([r["val_loss"] for r in want]))
