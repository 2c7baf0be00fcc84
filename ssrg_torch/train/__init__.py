from ssrg_torch.train.node_classification import (  # noqa: F401
    Prepared,
    prepare,
    slice_inputs,
)
