from ssrg_torch.configs.config import (  # noqa: F401
    DataAugmentConfig,
    DataConfig,
    DataProcessConfig,
    FrameworkConfig,
    ModelConfig,
    TrainingConfig,
    WaveletConfig,
)
