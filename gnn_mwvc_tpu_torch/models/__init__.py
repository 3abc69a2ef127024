from gnn_mwvc_tpu_torch.models.gnn import (  # noqa: F401
    MWVCModel,
    build_reference_arch,
    init_params,
    score_graph,
)
from gnn_mwvc_tpu_torch.models.serialize import (  # noqa: F401
    ModelSpec,
    dumps_model,
    load_model,
    load_pretrained,
    loads_model,
    params_from_jax,
    params_to_jax,
    save_model,
)


def pretrained_model(device=None) -> MWVCModel:
    """The published SEA-2022 model as a module on ``device``."""
    return MWVCModel.from_spec(load_pretrained(), device=device)
