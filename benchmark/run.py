"""Run one cell once and print its result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA devices as the cell's ``chips`` and exits non-zero
without a result otherwise; it never falls back to the CPU. A cell on several
chips runs one process a card: this process is rank 0, starts the others
with the same arguments and ``--rank``, and they meet at a file store in a
temporary directory. Only rank 0 prints. ``--device cpu`` (with
``--override``, a JSON file of tiny sizes) is for the tests alone: its line
names the CPU, which no check of the chip accepts.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# keep libraries the program may use from loading JAX themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--override", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def spawn_ranks(argv: list[str], world: int, store: str) -> list[subprocess.Popen]:
    procs = []
    for r in range(1, world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        log = open(os.path.join(store, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, "-m", "benchmark.run", *argv, "--rank", str(r), "--store", store],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait_ranks(procs: list[subprocess.Popen], store: str, timeout: float = 120.0) -> list[str]:
    """Wait for every rank; the logs of those that failed."""
    bad = []
    for r, p in enumerate(procs, start=1):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        if rc != 0:
            with open(os.path.join(store, f"rank{r}.log")) as f:
                bad.append(f"rank {r} exited {rc}:\n{f.read()[-4000:]}")
    return bad


def main(argv=None) -> int:
    raw = sys.argv[1:] if argv is None else list(argv)
    args = parse(raw)
    import torch

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    world = int(cell["chips"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs on the card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < world:
            print(f"cell {args.workload} needs {world} CUDA devices, found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    overrides = None
    if args.override:
        with open(args.override) as f:
            overrides = json.load(f)

    own_store = None
    procs: list[subprocess.Popen] = []
    store = args.store
    if world > 1 and args.rank == 0:
        own_store = tempfile.TemporaryDirectory(prefix="bench-ranks-")
        store = own_store.name
        os.environ.update(RANK="0", WORLD_SIZE=str(world), LOCAL_RANK="0")
        procs = spawn_ranks(raw, world, store)
    try:
        line = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace), device=args.device, rank=args.rank,
            world=world, store=store, overrides=overrides, t0=T0,
        )
    finally:
        bad = wait_ranks(procs, store) if procs else []
        if own_store is not None:
            own_store.cleanup()
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    if line is None:
        return 0
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(harness.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
