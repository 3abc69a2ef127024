from gnn_mwvc_tpu_torch.models.gnn import MWVCModel, score_graph  # noqa: F401
from gnn_mwvc_tpu_torch.models.serialize import (  # noqa: F401
    ModelSpec,
    load_model,
    load_pretrained,
    loads_model,
    params_from_jax,
)


def pretrained_model(device=None) -> MWVCModel:
    """The published SEA-2022 model as a module on ``device``."""
    return MWVCModel.from_spec(load_pretrained(), device=device)
