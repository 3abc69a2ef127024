from gnn_mwvc_tpu_torch.train.data import (  # noqa: F401
    TrainSample,
    gen_reduced_graph,
    load_training_set,
    make_sample,
)
from gnn_mwvc_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    evaluate,
    loss_and_metrics,
    train,
)
