from ssrg_torch.train.common import accuracy, seed_everything  # noqa: F401
from ssrg_torch.train.node_classification import (  # noqa: F401
    NodeClassification,
    Prepared,
    prepare,
    slice_inputs,
)
