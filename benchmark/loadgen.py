"""The serve cell's open-loop client, in a process of its own so that its JSON
decoding takes nothing from the server's interpreter.

    python3 -m benchmark.loadgen --port P

reads one job a line on standard input: {"schedule": [[due_s, [indices]], ...],
"keep": [request numbers whose forecasts to keep], "out": path, "wait_s": s}.
A dispatcher sends each request at its due time from its own clock (a pool of
threads does the waiting for answers, so a slow answer delays no later
request); each request is timed from when it was due to when its answer was
read; the answers are decoded and checked only once all are in. It waits
for every answer up to ``wait_s`` past the last due time, writes
per request (due, sent, done, HTTP status, windows answered, well-formed) and
the kept forecasts to ``out`` (``.npz``), and prints one line when done.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# an open loop: the pool is wide enough that waiting answers never hold back a
# request that is due, also past the knee, where many are in flight
THREADS = 1024


def post(port: int, indices: list[int], timeout: float) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps({"indices": indices, "split": "test"})
        conn.request("POST", "/forecast", body=body, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def run_job(port: int, job: dict) -> dict:
    schedule = job["schedule"]
    keep = set(job.get("keep", []))
    wait_s = float(job.get("wait_s", 60.0))
    n = len(schedule)
    due = np.array([d for d, _ in schedule], dtype=np.float64)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, dtype=np.int32)
    answered = np.zeros(n, dtype=np.int32)
    payloads: dict[int, bytes] = {}
    deadline_s = float(due[-1]) + wait_s if n else wait_s

    def one(i: int, t0: float) -> None:
        idx = schedule[i][1]
        sent[i] = time.perf_counter() - t0
        try:
            code, payload = post(port, idx, timeout=max(1.0, deadline_s - sent[i]))
            done[i] = time.perf_counter() - t0
            status[i] = code
            if code == 200:
                payloads[i] = payload
        except (OSError, http.client.HTTPException):
            status[i] = -1

    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        t0 = time.perf_counter()
        futures = []
        for i in range(n):
            pause = due[i] - (time.perf_counter() - t0)
            if pause > 0:
                time.sleep(pause)
            futures.append(pool.submit(one, i, t0))
        for f in futures:
            f.result()
    # decoded once every answer is in, so that decoding takes no time from
    # the sending
    kept: dict[int, np.ndarray] = {}
    for i, payload in payloads.items():
        try:
            fc = np.asarray(json.loads(payload)["forecast"], dtype=np.float64)
        except (ValueError, KeyError):
            continue
        if fc.ndim == 3 and fc.shape[0] == len(schedule[i][1]) and np.isfinite(fc).all():
            answered[i] = len(schedule[i][1])
            if i in keep:
                kept[i] = fc
    arrays = {"due": due, "sent": sent, "done": done, "status": status, "answered": answered}
    for i, fc in kept.items():
        arrays[f"forecast_{i}"] = fc
    np.savez(job["out"], **arrays)
    late = sent - due
    return {"requests": n, "late_p99_ms": float(np.nanpercentile(late, 99) * 1e3) if n else 0.0,
            "late_max_ms": float(np.nanmax(late) * 1e3) if n else 0.0}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    args = p.parse_args()
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        if not line.strip():
            continue
        out = run_job(args.port, json.loads(line))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
