"""Kernel launches the host made per window trained in the traced epoch: the
profiler's cudaLaunchKernel / cuLaunchKernel calls and their Ex forms."""


def read(record: dict) -> float | None:
    t = record.get("trace")
    if not t or not t["launches"] or not t.get("windows"):
        return None
    return t["launches"] / t["windows"]
