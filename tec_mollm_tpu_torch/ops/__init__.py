"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``_build`` compiles ``csrc/*.cu`` on first use and keeps the launch counts.
"""

from tec_mollm_tpu_torch.ops._build import launch_counts, reset_counts
from tec_mollm_tpu_torch.ops.add_layernorm import add_layernorm, add_layernorm_mirror
from tec_mollm_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    flash_attention,
    flash_attention_forward,
    flash_attention_reference,
)
from tec_mollm_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_reference
from tec_mollm_tpu_torch.ops.gat_stencil import gat_stencil_attention, gat_stencil_reference
from tec_mollm_tpu_torch.ops.short_attention import (
    short_attention_backward,
    short_attention_forward,
    short_causal_attention,
    short_causal_attention_backward_reference,
    short_causal_attention_reference,
)
from tec_mollm_tpu_torch.ops.temporal_conv import temporal_conv, temporal_conv_mirror

__all__ = [
    "add_layernorm",
    "add_layernorm_mirror",
    "FLASH_MIN_SEQ",
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_reference",
    "fused_ln_mlp",
    "fused_ln_mlp_reference",
    "gat_stencil_attention",
    "gat_stencil_reference",
    "launch_counts",
    "reset_counts",
    "short_attention_backward",
    "short_attention_forward",
    "short_causal_attention",
    "short_causal_attention_backward_reference",
    "short_causal_attention_reference",
    "temporal_conv",
    "temporal_conv_mirror",
]
