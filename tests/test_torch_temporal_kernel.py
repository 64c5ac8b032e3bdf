"""PyTorch port: the temporal encoder's conv-block kernel (csrc/temporal_conv.cu).

On the CPU: its plain mirror (``ops/temporal_conv.py:temporal_conv_mirror``)
against the unfused ``MultiScaleConvBlock`` pair; ``TemporalEncoder``'s
dispatch (the kernel on eval calls on the card, the plain blocks otherwise,
each kernel call counted as ``temporal.kernel``), reached on the CPU by
adding "cpu" to ``KERNEL_DEVICES`` so that the op runs its mirror;
``temporal_takes``' reasons; the wrapper's refusals; the registered op's
shape function and an export that holds the op. The JAX block's parity is in
``test_torch_temporal_kernel_jax.py``.

On the card (marked ``cuda``, skipped without one; there: ``python -m pytest
tests/test_torch_temporal_kernel.py -m cuda --noconftest``, as tests/conftest.py
imports JAX, which the card machine lacks): the kernel against the mirror
at the flagship eval and serve batches and at a ragged count, the same bits
twice, one launch a call, and a whole ``TECMoLLM`` eval forward against the
plain path."""

import dataclasses
import importlib

import pytest
import torch

from tec_mollm_tpu_torch.config import PRESETS, Config, ModelConfig, tiny_config
from tec_mollm_tpu_torch.models import TECMoLLM, graph_inputs, temporal
from tec_mollm_tpu_torch.models.temporal import MultiScaleConvBlock, TemporalEncoder
from tec_mollm_tpu_torch.ops import _build
from tec_mollm_tpu_torch.serving.export import artifact_ops
from tec_mollm_tpu_torch.utils import profiler
from torch_card import card  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ops.temporal_conv is the function; the module by its path
tc = importlib.import_module("tec_mollm_tpu_torch.ops.temporal_conv")

L, CIN = 48, 22


def _seeded_(blocks, seed: int):
    """The blocks' initialisers, then GroupNorm affines and biases moved off
    their identity values, so that every parameter reaches the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for block in blocks:
            block.reset_parameters(g)
            for _, norm, _ in block.convs:
                norm.weight.add_(0.2 * torch.randn(norm.weight.shape, generator=g))
                norm.bias.add_(0.2 * torch.randn(norm.bias.shape, generator=g))
            for conv in [c for c, _, _ in block.convs] + [block.final_conv]:
                conv.bias.add_(0.1 * torch.randn(conv.bias.shape, generator=g))
    return blocks


def _encoder(cfg: ModelConfig = ModelConfig(), seed: int = 0, **arms) -> TemporalEncoder:
    enc = TemporalEncoder(cfg, **arms)
    _seeded_(enc.conv_embedder.embedder, seed)
    return enc.eval()


def _plain_blocks(blocks, x: torch.Tensor) -> torch.Tensor:
    """The unfused blocks on x (..., L, C): (prod(...), L / 4, 128)."""
    h = x.reshape(-1, *x.shape[-2:]).transpose(1, 2)
    for block in blocks:
        h = block(h)
    return h.transpose(1, 2)


def _kernel_count(enc: TemporalEncoder, x: torch.Tensor, grad: bool = False):
    """enc(x) under a profiler session: (the temporal.kernel count, the output)."""
    with torch.set_grad_enabled(grad), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = enc(x)
    return profiler.recorded()["counts"].get("temporal.kernel", 0), out


@pytest.fixture
def op_on_cpu(monkeypatch):
    """The kernel's dispatch on CPU tensors: the op runs its mirror there."""
    monkeypatch.setattr(temporal, "KERNEL_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("lead, cin, seed", [((5,), CIN, 0), ((2, 3), CIN, 1), ((4,), 17, 2), ((3,), 24, 3)])
def test_mirror_matches_the_unfused_blocks_in_fp32(lead, cin, seed):
    """In fp32 the mirror's roundings are no-ops: it is the unfused pair (its
    GroupNorm over all steps, GELU everywhere, the stride-2 1x1 convs) to
    fp32 rounding, on (S, L, C) and (B, N, L, C) inputs and at input widths
    the 24-channel padding takes."""
    blocks = _seeded_([MultiScaleConvBlock(cin, 64, 2), MultiScaleConvBlock(64, 128, 2)], seed)
    x = torch.randn(*lead, L, cin, generator=torch.Generator().manual_seed(10 + seed))
    with torch.no_grad():
        want = _plain_blocks(blocks, x)
        got = tc.temporal_conv_mirror(x, *tc.pack_blocks(blocks, torch.float32))
    assert got.shape == want.shape == (x[..., 0, 0].numel(), 12, 128)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_in_bf16_is_no_farther_from_fp32_than_the_plain_bf16_blocks(seed):
    """The kernel's arithmetic in bf16 (fp32 between the products, bf16 at the
    activations, y1 and the output) against the plain path in bf16 (which
    also rounds the conv outputs, GroupNorm's and GELU's): both held to the
    fp32 blocks, the mirror is the closer."""
    enc = _encoder(seed=seed)
    x = torch.randn(32, L, CIN, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ref = _plain_blocks(enc.conv_embedder.embedder, x)
        mirror = tc.temporal_conv_mirror(x.bfloat16(), *tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16))
        plain = _plain_blocks(enc.to(torch.bfloat16).conv_embedder.embedder, x.bfloat16())
    assert mirror.dtype == torch.bfloat16

    def gap(t):
        return float(torch.linalg.vector_norm(t.float() - ref) / torch.linalg.vector_norm(ref))

    assert gap(mirror) < gap(plain) < 0.02


def test_eval_call_takes_the_kernel(op_on_cpu):
    """An eval call that needs no gradient, in bf16 at the flagship widths and
    length, goes through the op once, on the (B, N, L, C) view as the model
    hands it, and gives the mirror's blocks under the patcher."""
    enc = _encoder().to(torch.bfloat16)
    x = torch.randn(2, L, 3, CIN, generator=torch.Generator().manual_seed(4)).bfloat16().transpose(1, 2)
    with torch.no_grad():
        assert enc.kernel_refusal(x) is None
    count, out = _kernel_count(enc, x)
    assert count == 1
    with torch.no_grad():
        blocks = tc.temporal_conv_mirror(x, *tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16))
        assert torch.equal(out, enc.patcher(blocks))
    assert out.shape == (6, ModelConfig().num_patches, ModelConfig().d_llm)


def _refusal_case(case: str):
    """(encoder, input, grad mode, a fragment of the reason) for each way a
    call runs the plain blocks."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, L, CIN, generator=g).bfloat16()
    if case == "train":
        return _encoder().to(torch.bfloat16).train(), x, False, "train mode"
    if case == "grad":
        return _encoder().to(torch.bfloat16), x.requires_grad_(), True, "requires grad"
    if case in ("fuse_branches", "lean_gn", "im2col"):
        return _encoder(**{case: True}).to(torch.bfloat16), x, False, f"the {case} arm"
    if case == "length":
        cfg = dataclasses.replace(ModelConfig(), temporal_seq_len=32)
        return _encoder(cfg).to(torch.bfloat16), torch.randn(3, 32, CIN, generator=g).bfloat16(), False, "48 input steps"
    if case == "fp32":
        return _encoder(), x.float(), False, "bf16"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["train", "grad", "fuse_branches", "lean_gn", "im2col", "length", "fp32"])
def test_plain_blocks_run_what_the_kernel_does_not_take(op_on_cpu, case):
    """Training, a call that needs a gradient, each ablation arm, a length
    and a dtype the kernel is not built for: the plain blocks, counted
    nowhere, with the reason ``kernel_refusal`` gives."""
    enc, x, grad, reason = _refusal_case(case)
    with torch.set_grad_enabled(grad):
        assert reason in enc.kernel_refusal(x)
    count, out = _kernel_count(enc, x, grad)
    assert count == 0
    with torch.set_grad_enabled(grad):
        want = enc.patcher(enc.conv_embedder(x.transpose(1, 2)).transpose(1, 2))
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_a_cpu_tensor_runs_the_plain_blocks():
    """Without "cpu" in KERNEL_DEVICES (the default) a CPU call runs the
    plain blocks: the kernel runs on the card."""
    enc = _encoder().to(torch.bfloat16)
    x = torch.randn(3, L, CIN).bfloat16()
    with torch.no_grad():
        assert "the kernel runs on the card" in enc.kernel_refusal(x)
    assert _kernel_count(enc, x)[0] == 0


@pytest.mark.parametrize("kwargs, match", [
    ({"dtype": torch.float32}, "bf16"),
    ({"in_channels": 25}, "1 to 24 input channels"),
    ({"channels": (64, 64)}, "channels"),
    ({"kernel_sizes": (3, 5)}, "kernel sizes"),
    ({"strides": (2, 1)}, "strides"),
    ({"length": 336}, "48 input steps"),
])
def test_temporal_takes_gives_its_reasons(kwargs, match):
    args = {"in_channels": CIN, "channels": (64, 128), "kernel_sizes": (3, 5, 7), "strides": (2, 2),
            "length": L, "dtype": torch.bfloat16}
    assert tc.temporal_takes(**args) is None
    reason = tc.temporal_takes(**{**args, **kwargs})
    assert reason is not None and match in reason


def test_the_flagship_and_scale_up_configs():
    """The flagship widths and length (the DeepSeek-V2-Lite config's front end
    too) take the kernel; scale_up's 336 steps run the plain blocks."""
    for name, takes in (("default", True), ("scale_up", False)):
        cfg = PRESETS[name]().resolved().model
        reason = tc.temporal_takes(cfg.spatial_channels, cfg.temporal_channel_list, cfg.conv_kernel_sizes,
                                   cfg.temporal_strides, cfg.temporal_seq_len, torch.bfloat16)
        assert (reason is None) == takes, (name, reason)


def test_wrapper_refuses_a_call_that_needs_a_gradient():
    """No backward: grad mode plus an input that requires grad raises, on the
    CPU as on the card (a meta tensor too); no_grad runs."""
    enc = _encoder().to(torch.bfloat16)
    w, p = tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16)
    x = torch.randn(2, L, CIN).bfloat16().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tc.temporal_conv(x, w, p)
    with torch.no_grad():
        assert not tc.temporal_conv(x, w, p).requires_grad
    meta = torch.empty(2, L, CIN, dtype=torch.bfloat16, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tc.temporal_conv(meta, w.to("meta"), p.to("meta"))


def test_device_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises: what the kernel does
    not take raises before any build, and without a CUDA toolchain the build
    itself raises."""
    w = torch.empty(tc.WEIGHT_ELEMENTS, dtype=torch.bfloat16, device="meta")
    p = torch.empty(tc.PARAMS, device="meta")
    x = torch.empty(4, L, CIN, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="bf16"):
        tc.temporal_conv(x.float(), w, p)
    with pytest.raises(ValueError, match="48 steps"):
        tc.temporal_conv(torch.empty(4, 36, CIN, dtype=torch.bfloat16, device="meta"), w, p)
    with pytest.raises(ValueError, match="48 steps of 1 to 24 channels"):
        tc.temporal_conv(torch.empty(4, L, 30, dtype=torch.bfloat16, device="meta"), w, p)
    with pytest.raises(ValueError, match="pack_blocks"):
        tc.temporal_conv(x, w[:-8], p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            tc.temporal_conv(x, w, p)


def test_registered_op_shape_function():
    """``tec_mollm::temporal_conv``'s shape function gives (prod(lead), 12, 128)
    in the weights' dtype for (S, L, C) and (B, N, L, C) inputs, and the op
    passes torch.library's checks of its registration on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    enc = _encoder().to(torch.bfloat16)
    w, p = tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16)
    for lead in ((5,), (2, 7)):
        x = torch.randn(*lead, L, CIN).bfloat16()
        with FakeTensorMode() as mode:
            out = torch.ops.tec_mollm.temporal_conv(mode.from_tensor(x), mode.from_tensor(w), mode.from_tensor(p))
        assert tuple(out.shape) == (x[..., 0, 0].numel(), 12, 128) and out.dtype == torch.bfloat16
    torch.library.opcheck(tc.temporal_conv_op, (torch.randn(2, 3, L, CIN).bfloat16(), w, p))


def test_export_holds_the_op_and_the_packing_follows_the_parameters(op_on_cpu):
    """An exported eval encoder holds one temporal_conv node (the weights
    packed in its graph) and no convolution, and gives the eager output;
    eager calls after the export still run, and a changed parameter is
    packed again."""
    enc = _encoder().to(torch.bfloat16).requires_grad_(False)
    x = torch.randn(2, 3, L, CIN, generator=torch.Generator().manual_seed(6)).bfloat16()
    with torch.no_grad():
        eager = enc(x)
        ep = torch.export.export(enc, (x,))
        ops = artifact_ops(ep)
        assert ops.get("tec_mollm.temporal_conv") == 1 and "aten.convolution" not in ops
        assert torch.equal(ep.module()(x), eager)
        assert torch.equal(enc(x), eager)
        enc.conv_embedder.embedder[1].convs[2][1].weight.mul_(1.5)
        changed = enc(x)
        blocks = tc.temporal_conv_mirror(x, *tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16))
    assert not torch.equal(changed, eager) and torch.equal(changed, enc.patcher(blocks))


def test_model_eval_forward_through_the_op(op_on_cpu, monkeypatch):
    """A whole TECMoLLM eval forward (the tiny config at L_in 48, bf16) through
    the op once a call, against the plain path: both bf16, their conv blocks
    rounding at different places, so within a bf16 tolerance of the output's
    scale."""
    cfg = tiny_config(L_in=48)
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates

    graph = build_graph(*grid_coordinates(cfg.model.grid_h, cfg.model.grid_w))
    shifts, pair = graph_inputs(graph, "cpu")
    model = TECMoLLM(cfg.model, shifts, dtype=torch.bfloat16, pad_nodes_to=32, seed=3).eval()
    _seeded_(model.temporal_encoder.conv_embedder.embedder, 3)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 48, cfg.model.num_nodes, cfg.model.in_features, generator=g)
    tf = torch.zeros(2, 48, 4, dtype=torch.int64)
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = model(x, tf, *pair)
    assert profiler.recorded()["counts"]["temporal.kernel"] == 1
    monkeypatch.setattr(temporal, "KERNEL_DEVICES", ("cuda",))
    with torch.no_grad():
        want = model(x, tf, *pair)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=0.05 * float(want.abs().max()), rtol=0)


# ---------------------------------------------------------------- the card

def _card_inputs(card, b: int, n: int, seed: int):
    enc = _encoder(seed=seed).to(card)
    w, p = tc.pack_blocks(enc.conv_embedder.embedder, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(seed)
    # (B, N, L, C): the view of a (B, L, N, C) spatial-encoder output
    x = torch.randn(b, L, n, CIN, generator=g, device=card).bfloat16().transpose(1, 2)
    return x, w, p


@pytest.mark.cuda
@pytest.mark.parametrize("b, n", [(16, 2944), (8, 2944), (1, 2911 + 5)])
def test_kernel_matches_the_mirror(card, b, n):
    """The flagship eval batch (16 windows x 2,944 padded nodes = 47,104
    sequences), the serve batch (8 windows) and a ragged count (a last block
    with 4 live sequences of 8):
    |kernel - mirror| <= 1e-2 + 1e-2 |mirror|. Both accumulate in fp32 and
    round to bf16 at the same places; they differ in the order of the fp32
    sums (and the GELU's erf, within 1.2e-7), so an activation may round one
    bf16 ulp apart and carry that into block 2's sums."""
    x, w, p = _card_inputs(card, b, n, seed=b)
    with torch.no_grad():
        got = tc.temporal_conv(x, w, p)
        want = tc.temporal_conv_mirror(x, w, p)
    assert got.shape == (b * n, 12, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [17, 24])
def test_kernel_takes_every_input_width_and_a_flat_batch(card, cin):
    """Input widths other than the model's 22 (the padding to 24 channels),
    on a contiguous (S, L, C) batch: the same tolerance as above."""
    blocks = _seeded_([MultiScaleConvBlock(cin, 64, 2), MultiScaleConvBlock(64, 128, 2)], cin)
    w, p = (t.to(card) for t in tc.pack_blocks(blocks, torch.bfloat16))
    x = torch.randn(1000, L, cin, generator=torch.Generator(device=card).manual_seed(cin), device=card).bfloat16()
    with torch.no_grad():
        got = tc.temporal_conv(x, w, p)
        want = tc.temporal_conv_mirror(x, w, p)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_twice_in_one_launch_a_call(card):
    x, w, p = _card_inputs(card, 4, 2944, seed=5)
    _build.reset_counts()
    with torch.no_grad():
        first = tc.temporal_conv(x, w, p)
        torch.cuda.synchronize()
        assert _build.launch_counts() == {"temporal_conv": 1}
        second = tc.temporal_conv(x, w, p)
    assert torch.equal(first, second)
    assert _build.launch_counts() == {"temporal_conv": 2}


@pytest.mark.cuda
def test_model_eval_forward_kernel_against_the_plain_path(card, monkeypatch):
    """The flagship model's eval forward in bf16 (batch 2) with the kernel and
    on the plain path, each against an fp32 forward of the plain path: the
    kernel path is no farther from it than the plain path (plus a tenth), and
    the two bf16 paths lie within 3% of each other (relative 2-norm): each is
    about 1% from fp32 after 3 GPT-2 blocks in bf16, at different roundings."""
    from tec_mollm_tpu_torch.graph import build_graph, grid_coordinates

    cfg = Config().resolved().model
    graph = build_graph(*grid_coordinates(cfg.grid_h, cfg.grid_w))
    shifts, pair = graph_inputs(graph, card)
    model = TECMoLLM(cfg, shifts, dtype=torch.bfloat16, seed=0).to(card).eval()
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(2, cfg.temporal_seq_len, cfg.num_nodes, cfg.in_features, generator=g, device=card)
    tf = torch.zeros(2, cfg.temporal_seq_len, 4, dtype=torch.int64, device=card)
    _build.reset_counts()
    with torch.no_grad():
        kernel = model(x, tf, *pair)
        assert _build.launch_counts().get("temporal_conv") == 1
        monkeypatch.setattr(temporal, "KERNEL_DEVICES", ())
        plain = model(x, tf, *pair)
        model.dtype = torch.float32
        ref = model.float()(x, tf, *pair)

    def gap(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    assert gap(kernel, ref) <= 1.1 * gap(plain, ref)
    assert gap(kernel, plain) < 0.03
