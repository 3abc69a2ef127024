from gnn_mwvc_tpu_torch.graphio.edgelist import (  # noqa: F401
    gen_weights,
    mtx_to_metis,
    read_edge_graph,
    read_mtx_edges,
    write_edge_graph,
)
from gnn_mwvc_tpu_torch.graphio.metis import read_metis, write_metis  # noqa: F401
from gnn_mwvc_tpu_torch.graphio.validate import (  # noqa: F401
    cover_cost,
    independent_set_to_cover,
    is_independent_set,
    is_vertex_cover,
    read_solution,
    write_solution,
)
