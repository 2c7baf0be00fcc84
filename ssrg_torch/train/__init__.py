from ssrg_torch.train.common import accuracy, seed_everything  # noqa: F401
from ssrg_torch.train.node_classification import (  # noqa: F401
    NodeClassification,
    Prepared,
    prepare,
    slice_inputs,
)
from ssrg_torch.train.link_classification import LinkClassification  # noqa: F401
from ssrg_torch.train.augment_train import TrainModel  # noqa: F401
from ssrg_torch.train.base_task import BaseTask  # noqa: F401
from ssrg_torch.train.baseline_task import BaselineTask  # noqa: F401
