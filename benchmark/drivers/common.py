"""What the drivers share: the program's configuration object, its graph, the
seeded weights, and the numbers that compare forecasts."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import graphfile
from benchmark import weights as weights_lib
from benchmark.reference import model as ref


def program_config(ctx):
    """The program's ``Config`` from the configuration file, the run's seed as
    its training seed."""
    from tec_mollm_tpu_torch.config import Config

    raw = {k: dict(ctx.config[k]) for k in ("model", "train", "data")}
    raw["train"]["seed"] = train_seed(ctx.seed)
    return Config.from_dict(raw).resolved()


def train_seed(seed: int) -> int:
    return seed % 2**32


def program_graph(ctx):
    from tec_mollm_tpu_torch.graph.builder import GraphData

    arrays = graphfile.arrays(ctx.config)
    arrays["num_nodes"] = int(arrays["num_nodes"])
    return GraphData(**arrays)


def seeded_weights(ctx) -> dict[str, torch.Tensor]:
    return weights_lib.make(ctx.config, ctx.seed, ctx.device)


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_setup(ctx) -> tuple[dict, ref.Dims, ref.Graph]:
    """TF32 off, the reference's weights and graph on the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return seeded_weights(ctx), ref.Dims.of(ctx.config), ref.Graph(ctx.config, ctx.device)


def reference_forecasts(ctx, data: dict, starts: np.ndarray, prec: ref.Precision, block: int = 8) -> np.ndarray:
    """(W, L_out, N) scaled predictions of the windows at ``starts``, in blocks."""
    from benchmark import traffic

    params, dims, graph = reference_setup(ctx)
    out = []
    with torch.no_grad():
        for i in range(0, len(starts), block):
            x, tf, _ = traffic.windows_of(data, starts[i:i + block], dims.l_in)
            x = torch.as_tensor(x, device=ctx.device)
            tf = torch.as_tensor(tf, device=ctx.device)
            out.append(ref.forward(params, x, tf, graph, dims, prec)[..., 0].cpu().numpy())
    return np.concatenate(out).astype(np.float64)


def relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want - mean(want)||: the forecasts' gap against
    their own spread, the same in scaled units and in TECU."""
    spread = np.linalg.norm(want - want.mean())
    return float(np.linalg.norm(got - want) / max(spread, 1e-30))
