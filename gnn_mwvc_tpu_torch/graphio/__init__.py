from gnn_mwvc_tpu_torch.graphio.edgelist import (  # noqa: F401
    read_edge_graph,
    write_edge_graph,
)
from gnn_mwvc_tpu_torch.graphio.metis import read_metis, write_metis  # noqa: F401
from gnn_mwvc_tpu_torch.graphio.validate import (  # noqa: F401
    cover_cost,
    is_vertex_cover,
    read_solution,
    write_solution,
)
