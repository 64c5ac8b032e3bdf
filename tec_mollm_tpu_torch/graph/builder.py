"""Geographic graph of the TEC grid: COO export, padded neighbour table, stencil.

A copy of the JAX package's ``graph/builder.py`` (same arrays, same ``graph.npz``
layout), so a graph written by either package loads in the other. The reference
builds the graph in ``graph_constructor.py``: row-major 41x71 nodes, haversine
distances (R = 6371 km), binary adjacency at 150 km without self loops, and
symmetric normalisation.

On a regular lat/lon grid the 150 km neighbourhood is a fixed set of (dlat, dlon)
offsets: ``build_grid_stencil`` turns it into lane shifts of the node axis plus a
per-offset validity mask, which is the form the stencil GAT kernel reads.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GraphData:
    """Static graph in COO (parity with reference export), padded-table, and —
    for regular lat/lon grids — stencil form.

    Stencil form (TPU-first): on a regular grid the 150 km neighborhood is a fixed
    set of (dlat, dlon) offsets, so the neighbor gather is a set of lane shifts of
    the node axis: neighbor index = n + (di * W + dj). `stencil_shifts` holds those
    flattened shifts (self loop included as shift 0); `stencil_valid[o, n]` says
    whether node n really has a neighbor at offset o (grid bounds + latitude-
    dependent distance cutoff). Exactly equivalent to the padded table.
    """

    edge_index: np.ndarray   # (2, E) int32, [src; dst], sorted by dst then src
    edge_weight: np.ndarray  # (E,) float32 — sym-normalized adjacency values
    neighbors: np.ndarray    # (N, D) int32 padded neighbor ids; row i lists j : (j->i)
    neighbor_mask: np.ndarray  # (N, D) bool, True where a real neighbor
    neighbor_weight: np.ndarray  # (N, D) float32 normalized weights, 0 where padded
    num_nodes: int
    stencil_shifts: np.ndarray | None = None  # (O,) int32 flattened lane shifts
    stencil_valid: np.ndarray | None = None   # (O, N) bool

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def has_stencil(self) -> bool:
        return self.stencil_shifts is not None

    def save(self, path: str) -> None:
        extra = {}
        if self.has_stencil:
            extra = {
                "stencil_shifts": self.stencil_shifts,
                "stencil_valid": self.stencil_valid,
            }
        np.savez(
            path,
            edge_index=self.edge_index,
            edge_weight=self.edge_weight,
            neighbors=self.neighbors,
            neighbor_mask=self.neighbor_mask,
            neighbor_weight=self.neighbor_weight,
            num_nodes=np.int64(self.num_nodes),
            **extra,
        )

    @classmethod
    def load(cls, path: str) -> "GraphData":
        with np.load(path) as d:
            return cls(
                edge_index=d["edge_index"],
                edge_weight=d["edge_weight"],
                neighbors=d["neighbors"],
                neighbor_mask=d["neighbor_mask"],
                neighbor_weight=d["neighbor_weight"],
                num_nodes=int(d["num_nodes"]),
                stencil_shifts=d["stencil_shifts"] if "stencil_shifts" in d else None,
                stencil_valid=d["stencil_valid"] if "stencil_valid" in d else None,
            )


def node_coordinates(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """meshgrid(lat x lon) -> (N, 2) [lat, lon] degrees, row-major like the reference
    (graph_constructor.py:46-47: lon_grid, lat_grid = meshgrid(lon, lat))."""
    lon_grid, lat_grid = np.meshgrid(lon, lat)
    return np.stack([lat_grid.ravel(), lon_grid.ravel()], axis=1)


def haversine_distance_matrix(
    lat: np.ndarray, lon: np.ndarray, earth_radius_km: float = 6371.0
) -> np.ndarray:
    """Pairwise great-circle distances in km, vectorized first-party haversine."""
    coords = np.radians(node_coordinates(lat, lon))
    lat_r = coords[:, 0]
    lon_r = coords[:, 1]
    dlat = 0.5 * (lat_r[:, None] - lat_r[None, :])
    dlon = 0.5 * (lon_r[:, None] - lon_r[None, :])
    a = np.sin(dlat) ** 2 + np.cos(lat_r)[:, None] * np.cos(lat_r)[None, :] * np.sin(dlon) ** 2
    a = np.clip(a, 0.0, 1.0)
    return (2.0 * earth_radius_km) * np.arcsin(np.sqrt(a))


def construct_binary_adjacency(
    distance_matrix: np.ndarray, distance_threshold_km: float = 150.0
) -> np.ndarray:
    """A[i,j] = 1 iff dist <= threshold, no self-loops (graph_constructor.py:61-81)."""
    adj = (distance_matrix <= distance_threshold_km).astype(np.int64)
    np.fill_diagonal(adj, 0)
    return adj


def symmetrically_normalize(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2 with zero-degree rows mapped to zero
    (graph_constructor.py:99-128)."""
    degree = adj.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore"):
        inv_sqrt = 1.0 / np.sqrt(degree)
    inv_sqrt[~np.isfinite(inv_sqrt)] = 0.0
    return adj * inv_sqrt[:, None] * inv_sqrt[None, :]


def to_coo(normalized: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense normalized adjacency -> COO (edge_index (2,E), edge_weight (E,)).

    Row-major nonzero order, matching scipy coo_matrix construction from a dense
    array (graph_constructor.py:112, :141-144).
    """
    src, dst = np.nonzero(normalized)
    edge_index = np.stack([src, dst]).astype(np.int32)
    edge_weight = normalized[src, dst].astype(np.float32)
    return edge_index, edge_weight


def build_padded_neighbors(
    edge_index: np.ndarray,
    edge_weight: np.ndarray,
    num_nodes: int,
    include_self_loops: bool = True,
    pad_to_multiple: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO edges -> padded per-destination neighbor table.

    Row i of the output lists source nodes j with an edge (j -> i). With
    ``include_self_loops`` the node itself is appended as the final real entry,
    matching GATv2Conv(add_self_loops=True) (reference modules.py:335). Padding
    entries point at node i itself but are masked out.

    Returns (neighbors (N, D) int32, mask (N, D) bool, weights (N, D) float32).
    """
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    dst_sorted = dst[order]
    w_sorted = edge_weight[order]

    counts = np.bincount(dst_sorted, minlength=num_nodes)
    max_deg = int(counts.max()) + (1 if include_self_loops else 0)
    if pad_to_multiple > 1:
        max_deg = -(-max_deg // pad_to_multiple) * pad_to_multiple

    neighbors = np.tile(np.arange(num_nodes, dtype=np.int32)[:, None], (1, max_deg))
    mask = np.zeros((num_nodes, max_deg), dtype=bool)
    weights = np.zeros((num_nodes, max_deg), dtype=np.float32)

    # slot position of each edge within its destination row
    starts = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(dst_sorted)) - starts[dst_sorted]

    neighbors[dst_sorted, slot] = src_sorted.astype(np.int32)
    mask[dst_sorted, slot] = True
    weights[dst_sorted, slot] = w_sorted

    if include_self_loops:
        self_slot = counts  # first free slot per row
        rows = np.arange(num_nodes)
        neighbors[rows, self_slot] = rows.astype(np.int32)
        mask[rows, self_slot] = True
        # self-loop weight stays 0: the reference's sym-normalized adjacency has a
        # zero diagonal and GATv2 ignores edge_weight anyway (modules.py:355-356).

    return neighbors, mask, weights


def haversine_km(lat1, lon1, lat2, lon2, earth_radius_km: float = 6371.0):
    """Elementwise great-circle distance in km (degrees in)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    a = (
        np.sin(0.5 * (lat2 - lat1)) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin(0.5 * (lon2 - lon1)) ** 2
    )
    return 2.0 * earth_radius_km * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def build_grid_stencil(
    lat: np.ndarray,
    lon: np.ndarray,
    distance_threshold_km: float = 150.0,
    earth_radius_km: float = 6371.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Offset-stencil form of the threshold graph on a regular lat/lon grid.

    Returns (shifts (O,) int32, valid (O, N) bool): shift o maps node n to
    neighbor n + shifts[o]; valid[o, n] marks in-bounds pairs within the distance
    threshold. Offset (0, 0) — the GAT self-loop (modules.py:335) — is always
    included and always valid. Works for any monotone grid spacing (the validity
    mask is computed per node, so latitude-dependent lon spacing is exact).
    """
    h, w = len(lat), len(lon)
    n = h * w
    # generous candidate ranges from the smallest spacing anywhere on the grid
    lat_step = np.min(np.abs(np.diff(lat))) if h > 1 else np.inf
    min_coslat = np.min(np.cos(np.radians(lat)))
    lon_step_km = (
        np.min(np.abs(np.diff(lon))) * 111.195 * max(min_coslat, 1e-6)
        if w > 1
        else np.inf
    )
    max_di = 0 if h == 1 else int(distance_threshold_km // (lat_step * 111.195)) + 1
    max_dj = 0 if w == 1 else int(distance_threshold_km // lon_step_km) + 1
    max_dj = min(max_dj, w - 1)
    max_di = min(max_di, h - 1)

    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    shifts: list[int] = []
    valids: list[np.ndarray] = []
    for di in range(-max_di, max_di + 1):
        for dj in range(-max_dj, max_dj + 1):
            i2 = ii + di
            j2 = jj + dj
            in_bounds = (i2 >= 0) & (i2 < h) & (j2 >= 0) & (j2 < w)
            i2c = np.clip(i2, 0, h - 1)
            j2c = np.clip(j2, 0, w - 1)
            if di == 0 and dj == 0:
                valid = np.ones((h, w), dtype=bool)  # self loop
            else:
                dist = haversine_km(
                    lat[ii], lon[jj], lat[i2c], lon[j2c], earth_radius_km
                )
                valid = in_bounds & (dist <= distance_threshold_km)
            if valid.any():
                shifts.append(di * w + dj)
                valids.append(valid.reshape(n))
    return np.asarray(shifts, dtype=np.int32), np.stack(valids).astype(bool)


def build_graph(
    lat: np.ndarray,
    lon: np.ndarray,
    distance_threshold_km: float = 150.0,
    earth_radius_km: float = 6371.0,
    include_self_loops: bool = True,
    pad_to_multiple: int = 1,
) -> GraphData:
    """Full pipeline: coords -> distances -> adjacency -> normalize -> COO + padded."""
    dist = haversine_distance_matrix(lat, lon, earth_radius_km)
    adj = construct_binary_adjacency(dist, distance_threshold_km)
    normalized = symmetrically_normalize(adj)
    edge_index, edge_weight = to_coo(normalized)
    neighbors, mask, weights = build_padded_neighbors(
        edge_index,
        edge_weight,
        num_nodes=len(lat) * len(lon),
        include_self_loops=include_self_loops,
        pad_to_multiple=pad_to_multiple,
    )
    stencil_shifts, stencil_valid = build_grid_stencil(
        lat, lon, distance_threshold_km, earth_radius_km
    )
    logger.info(
        "graph: %d nodes, %d edges, max padded degree %d, stencil offsets %d",
        len(lat) * len(lon),
        edge_index.shape[1],
        neighbors.shape[1],
        len(stencil_shifts),
    )
    return GraphData(
        edge_index=edge_index,
        edge_weight=edge_weight,
        neighbors=neighbors,
        neighbor_mask=mask,
        neighbor_weight=weights,
        num_nodes=len(lat) * len(lon),
        stencil_shifts=stencil_shifts,
        stencil_valid=stencil_valid,
    )


# Default 1-degree China-region grid: 41 x 71 = 2911 nodes from (10N, 70E).
DEFAULT_LAT0 = 10.0
DEFAULT_LON0 = 70.0


def grid_coordinates(grid_h: int = 41, grid_w: int = 71) -> tuple[np.ndarray, np.ndarray]:
    """Latitudes and longitudes (degrees) of the default 1-degree grid."""
    lat = DEFAULT_LAT0 + np.arange(grid_h, dtype=np.float64)
    lon = DEFAULT_LON0 + np.arange(grid_w, dtype=np.float64)
    return lat, lon
