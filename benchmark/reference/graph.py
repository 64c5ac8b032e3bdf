"""The grid graph, worked out from the grid's coordinates.

TEC-MoLLM's graph (``graph_constructor.py`` of the reference): row-major grid
nodes, haversine distances on a sphere of radius R, an edge between two nodes
at most ``threshold_km`` apart, and GATv2's self loop. On a regular lat/lon
grid that neighbourhood is a set of (dlat, dlon) offsets with a per-node
validity; ``offsets`` lists them row offset first, as the program draws its
attention-dropout masks offset by offset in that order. ``dense_neighbors``
gives the same neighbourhood from the full distance matrix, for the tests.
"""

from __future__ import annotations

import numpy as np


def coordinates(grid: dict, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    lat = grid["lat0_deg"] + grid["step_deg"] * np.arange(h, dtype=np.float64)
    lon = grid["lon0_deg"] + grid["step_deg"] * np.arange(w, dtype=np.float64)
    return lat, lon


def haversine_km(lat1, lon1, lat2, lon2, radius_km: float) -> np.ndarray:
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    a = np.sin(0.5 * (lat2 - lat1)) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(0.5 * (lon2 - lon1)) ** 2
    return 2.0 * radius_km * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def offsets(lat: np.ndarray, lon: np.ndarray, threshold_km: float, radius_km: float):
    """(shifts (O,) of the flattened node index, neighbour index (O, N),
    valid (O, N)): node n's neighbour at offset o is ``n + shifts[o]`` where
    ``valid[o, n]``; offset (0, 0) is the self loop, always valid."""
    h, w = len(lat), len(lon)
    n = h * w
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    # every offset that some node can reach: 1 degree of latitude is at least
    # 110 km, a degree of longitude at least 110 km * cos(max |lat|)
    max_di = min(h - 1, int(threshold_km // (np.min(np.abs(np.diff(lat))) * 111.195)) + 1) if h > 1 else 0
    coslat = max(np.min(np.cos(np.radians(lat))), 1e-6)
    max_dj = min(w - 1, int(threshold_km // (np.min(np.abs(np.diff(lon))) * 111.195 * coslat)) + 1) if w > 1 else 0
    shifts, index, valid = [], [], []
    for di in range(-max_di, max_di + 1):
        for dj in range(-max_dj, max_dj + 1):
            i2, j2 = ii + di, jj + dj
            inside = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
            i2c, j2c = np.clip(i2, 0, h - 1), np.clip(j2, 0, w - 1)
            if di == 0 and dj == 0:
                ok = np.ones((h, w), dtype=bool)
            else:
                ok = inside & (haversine_km(lat[ii], lon[jj], lat[i2c], lon[j2c], radius_km) <= threshold_km)
            if ok.any():
                shifts.append(di * w + dj)
                index.append((i2c * w + j2c).reshape(n))
                valid.append(ok.reshape(n))
    return np.asarray(shifts, np.int64), np.stack(index), np.stack(valid)


def dense_neighbors(lat: np.ndarray, lon: np.ndarray, threshold_km: float, radius_km: float) -> list[set[int]]:
    """Each node's neighbours (itself included) from the full distance matrix."""
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    la, lo = la.ravel(), lo.ravel()
    dist = haversine_km(la[:, None], lo[:, None], la[None, :], lo[None, :], radius_km)
    return [set(np.nonzero(row <= threshold_km)[0].tolist()) for row in dist]
