from ssrg_torch.models.heads import (  # noqa: F401
    FeatureAugment2MLP,
    IdenticalMapping,
    Layer2GraphConvolution,
    LogisticRegression,
    MultiLayerPerceptron,
    PReLU,
    ResMultiLayerPerceptron,
)
from ssrg_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    ModelSpec,
    PrecomputeModel,
    load_model,
)
