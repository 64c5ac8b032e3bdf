"""Time one all-reduce of the tensor-parallel activations over gloo with the
ranks sharing one card: gloo's own path for a CUDA tensor, the same sum
staged by hand through pageable host memory (``.cpu()`` and back), through a
reused pinned buffer, and a CPU tensor alone.

    python -m torch.distributed.run --standalone --nproc_per_node 2 scripts/bench_gloo_allreduce.py

The sizes are a trainer microbatch of the flagship config (2 windows x 2944
padded nodes x 3 patches = 17,664 rows of 768 fp32) and an eval batch of 16
windows (141,312 rows). Rank 0 prints one line per size and variant: the
mean of 10 calls after 2 warm-ups, and the payload over that time.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tec_mollm_tpu_torch import parallel  # noqa: E402

ROWS, WIDTH, CALLS, WARMUP = (17664, 141312), 768, 10, 2


def main() -> None:
    dev = parallel.init_distributed(backend="gloo")
    try:
        for rows in ROWS:
            t = torch.randn(rows * WIDTH, device=dev)
            pinned = torch.empty(t.shape, pin_memory=True)

            def gloo_cuda():
                dist.all_reduce(t)

            def pageable():
                host = t.cpu()
                dist.all_reduce(host)
                t.copy_(host)

            def pinned_buffer():
                pinned.copy_(t)
                dist.all_reduce(pinned)
                t.copy_(pinned, non_blocking=True)

            def cpu_only():
                dist.all_reduce(pinned)

            for name, fn in (("gloo_cuda", gloo_cuda), ("pageable", pageable), ("pinned", pinned_buffer),
                             ("cpu", cpu_only)):
                for _ in range(WARMUP):
                    fn()
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / CALLS
                if parallel.rank() == 0:
                    mb = t.numel() * t.element_size() / 1e6
                    print(f"{rows} rows ({mb:.1f} MB) {name}: {dt * 1e3:.1f} ms = {mb / 1e3 / dt:.2f} GB/s",
                          flush=True)
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
