from ssrg_torch.pipelines.sparsify import (  # noqa: F401
    edge_masked,
    feature_masked,
    run_sparsify,
    save_raw_dataset,
    sparsify_dataset,
)
from ssrg_torch.pipelines.augment import (  # noqa: F401
    augment_dataset,
    edge_augment,
    feature_augment,
    run_augment,
)
