"""``graph.npz`` for the program, in the layout its preprocess CLI writes.

The arrays come from the grid's coordinates alone: the haversine distance
matrix, edges at most the threshold apart (no self loops), their symmetric
normalisation, the padded per-node neighbour table with the self loop last,
and the stencil of ``reference.graph.offsets`` (shifts and validity).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import graph as graph_lib


def arrays(config: dict) -> dict[str, np.ndarray]:
    m, data = config["model"], config["data"]
    lat, lon = graph_lib.coordinates(config["grid"], m["grid_h"], m["grid_w"])
    thr, radius = data["distance_threshold_km"], data["earth_radius_km"]
    la, lo = (a.ravel() for a in np.meshgrid(lat, lon, indexing="ij"))
    n = la.size
    adj = (graph_lib.haversine_km(la[:, None], lo[:, None], la[None, :], lo[None, :], radius) <= thr).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    deg = adj.sum(1)
    inv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-300)), 0.0)
    norm = adj * inv[:, None] * inv[None, :]
    src, dst = np.nonzero(norm)
    edge_index = np.stack([src, dst]).astype(np.int32)
    edge_weight = norm[src, dst].astype(np.float32)
    order = np.argsort(dst, kind="stable")
    s_src, s_dst, s_w = src[order], dst[order], edge_weight[order]
    counts = np.bincount(s_dst, minlength=n)
    width = int(counts.max()) + 1
    neighbors = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
    mask = np.zeros((n, width), dtype=bool)
    weight = np.zeros((n, width), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(s_dst)) - starts[s_dst]
    neighbors[s_dst, slot], mask[s_dst, slot], weight[s_dst, slot] = s_src, True, s_w
    neighbors[np.arange(n), counts] = np.arange(n)
    mask[np.arange(n), counts] = True
    shifts, _, valid = graph_lib.offsets(lat, lon, thr, radius)
    return {"edge_index": edge_index, "edge_weight": edge_weight, "neighbors": neighbors, "neighbor_mask": mask,
            "neighbor_weight": weight, "num_nodes": np.int64(n), "stencil_shifts": shifts.astype(np.int32),
            "stencil_valid": valid}


def write(path: str, config: dict) -> None:
    np.savez(path, **arrays(config))
