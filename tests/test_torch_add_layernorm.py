"""PyTorch port: the GPT-2 backbone's residual add and LayerNorm kernel (csrc/add_layernorm.cu).

On the CPU: its plain mirror (``ops/add_layernorm.py:add_layernorm_mirror``)
against the plain add and ``lean_layernorm``, bit for bit; ``GPT2Backbone``'s
dispatch (the kernel on eval calls on the card, the plain norms otherwise,
each kernel call counted as ``llm.ln.kernel``), reached on the CPU by adding
"cpu" to ``models.gpt2.KERNEL_DEVICES`` so that the op runs its mirror;
``norm_kernel_refusal``'s and ``add_layernorm_takes``' reasons; the wrapper's
refusals; the registered op's shape function and an export that holds the op.

On the card (marked ``cuda``, skipped without one; there: ``python -m pytest
tests/test_torch_add_layernorm.py -m cuda --noconftest``, as tests/conftest.py
imports JAX, which the card machine lacks): the kernel against the mirror at
the flagship eval and serve row counts and a ragged count (s bit for bit, h
within ``TOL["bf16"]``), at the other widths it takes, the same bits twice,
one launch a call, and a whole ``TECMoLLM`` eval forward against the plain
path."""

import dataclasses
import importlib

import pytest
import torch

from card_cases import LN_ROWS, ln_inputs
from tec_mollm_tpu_torch.config import Config, ModelConfig, tiny_config
from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates
from tec_mollm_tpu_torch.models import TECMoLLM, gpt2, graph_inputs
from tec_mollm_tpu_torch.models.gpt2 import GPT2Backbone, LLMBackbone
from tec_mollm_tpu_torch.ops import _build
from tec_mollm_tpu_torch.serving import export as ex
from tec_mollm_tpu_torch.utils import profiler
from torch_card import assert_close, card  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ops.add_layernorm is the function; the module by its path
al = importlib.import_module("tec_mollm_tpu_torch.ops.add_layernorm")


def _seeded_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The module's LayerNorm affines moved off their identity values, so that
    both reach the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for ln in (m for m in module.modules() if isinstance(m, torch.nn.LayerNorm)):
            ln.weight.add_(0.2 * torch.randn(ln.weight.shape, generator=g))
            ln.bias.add_(0.2 * torch.randn(ln.bias.shape, generator=g))
    return module


def _backbone(cfg: ModelConfig, seed: int = 0, **kwargs) -> GPT2Backbone:
    bb = GPT2Backbone(cfg, **kwargs)
    bb.reset_parameters(torch.Generator().manual_seed(seed))
    return _seeded_(bb, seed).eval()


def _tokens(cfg: ModelConfig, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.randn(6, cfg.num_patches, cfg.d_llm, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _kernel_count(module, x: torch.Tensor, grad: bool = False):
    """module(x) under a profiler session: (the llm.ln.kernel count, the output)."""
    with torch.set_grad_enabled(grad), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = module(x)
    return profiler.recorded()["counts"].get("llm.ln.kernel", 0), out


@pytest.fixture
def op_on_cpu(monkeypatch):
    """The kernel's dispatch on CPU tensors: the op runs its mirror there."""
    monkeypatch.setattr(gpt2, "KERNEL_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("shape, dtype, residual", [
    ((7, 64), torch.bfloat16, True), ((2, 3, 768), torch.bfloat16, True), ((5, 40), torch.bfloat16, False),
    ((4, 3, 64), torch.float32, True),
])
def test_mirror_and_op_are_the_plain_add_and_lean_layernorm(shape, dtype, residual):
    """The mirror, and the op on a CPU tensor, give the plain add and
    ``lean_layernorm`` of it bit for bit: s = x + delta, h its LayerNorm (h
    alone without a residual)."""
    g = torch.Generator().manual_seed(len(shape))
    x, delta = (torch.randn(*shape, generator=g).to(dtype) for _ in range(2))
    w, b = 1.0 + 0.1 * torch.randn(shape[-1], generator=g), 0.1 * torch.randn(shape[-1], generator=g)
    s = x + delta if residual else x
    want = al.lean_layernorm(s, w, b, 1e-5)
    delta = delta if residual else None
    for fn in (al.add_layernorm_mirror, al.add_layernorm):
        got = fn(x, delta, w, b, 1e-5)
        if residual:
            assert torch.equal(got[0], s)
            got = got[1]
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("fused_mlp", [False, True], ids=["plain_mlp", "fused_mlp"])
def test_backbone_eval_takes_the_kernel(op_on_cpu, fused_mlp):
    """An eval call that needs no gradient, in bf16, runs every LayerNorm
    through the op and gives the plain path's output bit for bit: 2 L + 1
    calls a forward (block 0's ln_1 alone, each block's ln_2 and the next
    norm with their residual adds); with the fused MLP kernel, which keeps
    ln_2 and its residual, L + 1 (block 0's ln_1 and each next norm)."""
    cfg = tiny_config(llm_layers=3).model
    bb = _backbone(cfg, use_fused_mlp=fused_mlp)
    x = _tokens(cfg, 1)
    with torch.no_grad():
        assert bb.norm_kernel_refusal(x) is None
    count, got = _kernel_count(bb, x)
    assert count == (cfg.llm_layers + 1 if fused_mlp else 2 * cfg.llm_layers + 1)
    gpt2.KERNEL_DEVICES = ("cuda",)
    with torch.no_grad():
        want = bb(x)
    assert torch.equal(got, want)


def test_a_block_called_alone_is_unchanged(op_on_cpu):
    """``GPT2Block.forward`` computes what it computed before the kernel: its
    plain norms and residual adds, whatever the backbone's dispatch."""
    cfg = tiny_config().model
    bb = _backbone(cfg)
    block, x = bb.h[0], _tokens(cfg, 2)
    with torch.no_grad():
        ln1, ln2 = block.ln_1, block.ln_2
        y = x + block.attn(al.lean_layernorm(x, ln1.weight, ln1.bias))
        want = y + block.mlp(al.lean_layernorm(y, ln2.weight, ln2.bias))
    count, got = _kernel_count(block, x)
    assert count == 0 and torch.equal(got, want)


def _refusal_case(case: str):
    """(backbone, input, grad mode, a fragment of the reason) for each way a
    call runs the plain norms."""
    cfg = tiny_config().model
    if case == "train":
        return _backbone(cfg).train(), _tokens(cfg, 3), False, "train mode"
    if case == "grad":
        return _backbone(cfg), _tokens(cfg, 3), True, "requires grad"
    if case == "lean_ln":
        return _backbone(cfg, lean_ln=False), _tokens(cfg, 3), False, "lean_ln=False"
    if case == "fp32":
        return _backbone(cfg), _tokens(cfg, 3, torch.float32), False, "bf16"
    if case == "width":
        cfg = dataclasses.replace(cfg, d_llm=36, llm_heads=4)
        return _backbone(cfg), _tokens(cfg, 3), False, "multiples of 8, got 36"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["train", "grad", "lean_ln", "fp32", "width"])
def test_plain_norms_run_what_the_kernel_does_not_take(op_on_cpu, case):
    """Training, a call that needs a gradient, the byte LM's fp32 norms, a
    dtype and a width the kernel does not take: the plain norms, counted
    nowhere, with the reason ``norm_kernel_refusal`` gives."""
    bb, x, grad, reason = _refusal_case(case)
    with torch.set_grad_enabled(grad):
        assert reason in bb.norm_kernel_refusal(x)
    torch.manual_seed(0)
    count, got = _kernel_count(bb, x, grad)
    assert count == 0
    gpt2.KERNEL_DEVICES = ("cuda",)
    torch.manual_seed(0)
    with torch.set_grad_enabled(grad):
        want = bb(x)
    assert torch.equal(got, want)


def test_a_cpu_tensor_runs_the_plain_norms():
    """Without "cpu" in KERNEL_DEVICES (the default) a CPU call runs the
    plain norms: the kernel runs on the card."""
    cfg = tiny_config().model
    bb, x = _backbone(cfg), _tokens(cfg, 4)
    with torch.no_grad():
        assert "the kernel runs on the card" in bb.norm_kernel_refusal(x)
    assert _kernel_count(bb, x)[0] == 0


def test_deepseek_v2_backbone_takes_no_norm_kernel(op_on_cpu):
    """DeepSeek-V2's RMSNorm is another algorithm: its backbone counts no
    call, in eval and in bf16."""
    from tec_mollm_tpu_torch.config import DeepSeekV2Config

    ds = DeepSeekV2Config(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                          intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
                          num_experts_per_tok=2, n_shared_experts=1)
    cfg = dataclasses.replace(tiny_config(llm_layers=2).model, deepseek_v2=ds)
    llm = LLMBackbone(cfg).eval()
    assert _kernel_count(llm, _tokens(cfg, 5))[0] == 0


@pytest.mark.parametrize("d, dtype, match", [
    (768, torch.float32, "bf16"), (36, torch.bfloat16, "multiples of 8"), (4, torch.bfloat16, "widths of 8"),
    (2056, torch.bfloat16, "to 2048"),
])
def test_add_layernorm_takes_gives_its_reasons(d, dtype, match):
    for ok in (8, 768, 1600, 2048):
        assert al.add_layernorm_takes(ok, torch.bfloat16) is None
    reason = al.add_layernorm_takes(d, dtype)
    assert reason is not None and match in reason


def test_wrapper_refuses_a_call_that_needs_a_gradient():
    """No backward: grad mode plus an input that requires grad raises, on the
    CPU as on the card (a meta tensor too); no_grad runs."""
    x, delta, w, b = ln_inputs(4, "cpu", 0, d=64)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        al.add_layernorm(x, delta, w, b)
    with torch.no_grad():
        assert not al.add_layernorm(x, delta, w, b)[1].requires_grad
    meta = torch.empty(4, 64, dtype=torch.bfloat16, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        al.add_layernorm(meta, None, w.detach().to("meta"), b.to("meta"))


def test_device_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises: what the kernel does
    not take raises before any build, and without a CUDA toolchain the build
    itself raises."""
    x = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(TypeError, match="bf16"):
        al.add_layernorm(x.float(), None, w, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        al.add_layernorm(torch.empty(4, 60, dtype=torch.bfloat16, device="meta"), None, w[:60], w[:60])
    with pytest.raises(ValueError, match="delta must match"):
        al.add_layernorm(x, x[:2], w, w)
    with pytest.raises(ValueError, match=r"w must be \(64,\)"):
        al.add_layernorm(x, x, w[:32], w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            al.add_layernorm(x, x, w, w)


def test_registered_op_shape_function():
    """``tec_mollm::add_layernorm``'s shape function gives (2, *x.shape) with
    a residual and (1, *x.shape) without, in x's dtype, and the op passes
    torch.library's checks of its registration on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, delta, w, b = ln_inputs(6, "cpu", 1, d=64)
    x3, d3 = x.reshape(2, 3, 64), delta.reshape(2, 3, 64)
    for dl, lead in ((d3, 2), (None, 1)):
        with FakeTensorMode() as mode:
            out = torch.ops.tec_mollm.add_layernorm(
                mode.from_tensor(x3), None if dl is None else mode.from_tensor(dl), mode.from_tensor(w),
                mode.from_tensor(b), 1e-5)
        assert tuple(out.shape) == (lead, 2, 3, 64) and out.dtype == torch.bfloat16
        torch.library.opcheck(al.add_layernorm_op, (x3, dl, w, b, 1e-5))


def test_export_holds_the_op(op_on_cpu):
    """An exported bf16 forecaster on a 3-block backbone holds
    ``tec_mollm.add_layernorm`` 2 L + 1 = 7 times and gives the eager output."""
    cfg = tiny_config(llm_layers=3)
    graph = build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w))
    shifts, pair = graph_inputs(graph, "cpu")
    model = _seeded_(TECMoLLM(cfg.model, shifts, dtype=torch.bfloat16, seed=4), 4)
    ep = ex.export_forecaster(cfg, model.state_dict(), graph, batch_size=2, platforms=("cpu",))
    assert ex.artifact_ops(ep).get("tec_mollm.add_layernorm") == 2 * cfg.model.llm_layers + 1
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, cfg.train.L_in, cfg.model.num_nodes, cfg.model.in_features, generator=g).bfloat16()
    tf = torch.zeros(2, cfg.train.L_in, 4, dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(ep.module()(x, tf), model.eval()(x, tf, *pair))


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(LN_ROWS))
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
def test_kernel_matches_the_mirror(card, label, residual):
    """The eval batch's 141,312 rows of 768, the serve batch's 70,656 and a
    ragged count: s = x + delta bit for bit (one rounding of an fp32 sum in
    both), h within TOL["bf16"] (the fp32 statistics are summed in another
    order, so a normalised value may round one bf16 ulp apart)."""
    x, delta, w, b = ln_inputs(LN_ROWS[label], card, seed=len(label))
    with torch.no_grad():
        got = al.add_layernorm(x, delta if residual else None, w, b)
        want = al.add_layernorm_mirror(x, delta if residual else None, w, b)
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    assert got.shape == x.shape
    assert_close(got, want, "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1024, 1600, 2048])
def test_kernel_takes_every_width(card, d):
    """Widths other than GPT-2 small's 768: one piece a row, four a lane, a
    ragged last piece per lane (1600: 200 pieces over 32 lanes) and the
    widest it is built for, on a batch of (B, T, d) rows."""
    x, delta, w, b = ln_inputs(3 * 333, card, seed=d, d=d)
    x, delta = x.reshape(333, 3, d), delta.reshape(333, 3, d)
    with torch.no_grad():
        s, h = al.add_layernorm(x, delta, w.bfloat16(), b.bfloat16())
        want_s, want_h = al.add_layernorm_mirror(x, delta, w, b)
    assert torch.equal(s, want_s)
    assert_close(h, want_h, "bf16")


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_twice_in_one_launch_a_call(card):
    x, delta, w, b = ln_inputs(LN_ROWS["path"], card, seed=7)
    _build.reset_counts()
    with torch.no_grad():
        first = al.add_layernorm(x, delta, w, b)
        torch.cuda.synchronize()
        assert _build.launch_counts() == {"add_layernorm": 1}
        second = al.add_layernorm(x, delta, w, b)
    assert all(torch.equal(f, s) for f, s in zip(first, second))
    assert _build.launch_counts() == {"add_layernorm": 2}


@pytest.mark.cuda
def test_model_eval_forward_kernel_against_the_plain_path(card, monkeypatch):
    """The flagship model's eval forward in bf16 (batch 2) with the kernel
    (2 L + 1 = 7 launches) and on the plain norms, each against an fp32
    forward of the plain path: the kernel path is no farther from it than the
    plain path (plus a tenth), and the two bf16 paths lie within 3% of each
    other (relative 2-norm): each is about 1% from fp32 after 3 GPT-2 blocks
    in bf16, and they round the statistics' sums in different orders."""
    cfg = Config().resolved().model
    graph = build_graph(*grid_coordinates(cfg.grid_h, cfg.grid_w))
    shifts, pair = graph_inputs(graph, card)
    model = _seeded_(TECMoLLM(cfg, shifts, dtype=torch.bfloat16, seed=0), 0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(2, cfg.temporal_seq_len, cfg.num_nodes, cfg.in_features, generator=g, device=card)
    tf = torch.zeros(2, cfg.temporal_seq_len, 4, dtype=torch.int64, device=card)
    _build.reset_counts()
    with torch.no_grad():
        kernel = model(x, tf, *pair)
        assert _build.launch_counts().get("add_layernorm") == 2 * cfg.llm_layers + 1
        monkeypatch.setattr(gpt2, "KERNEL_DEVICES", ())
        plain = model(x, tf, *pair)
        model.dtype = torch.float32
        ref = model.float()(x, tf, *pair)

    def gap(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    assert gap(kernel, ref) <= 1.1 * gap(plain, ref)
    assert gap(kernel, plain) < 0.03
