from tec_mollm_tpu_torch.graph.builder import (
    GraphData,
    build_graph,
    build_grid_stencil,
    grid_coordinates,
)

__all__ = ["GraphData", "build_graph", "build_grid_stencil", "grid_coordinates"]
