from ssrg_torch.configs.config import (  # noqa: F401
    ModelConfig,
    TrainingConfig,
    WaveletConfig,
)
