from ssrg_torch.models.heads import (  # noqa: F401
    LogisticRegression,
    MultiLayerPerceptron,
    PReLU,
)
from ssrg_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    ModelSpec,
    PrecomputeModel,
    load_model,
)
