"""The configuration tree.

Same fields and defaults as ``ssrg_tpu/configs/config.py`` (``DataConfig``,
``DataProcessConfig``, ``DataAugmentConfig``, ``WaveletConfig``,
``ModelConfig``, ``TrainingConfig`` and ``FrameworkConfig``, which holds
one of each), so one set of settings drives either package. Fields that
select paths this port does not run yet are kept and refused where they
are read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class DataConfig:
    """Which dataset to load (``ssrg_tpu/configs/config.py:28-37``)."""

    data_name: str = "cora_0_0"
    data_root: str = "./sparsity_datasets/simhomo/Planetoid"
    data_split: str = "official"
    heterogeneity: bool = False


@dataclass
class DataProcessConfig:
    """The sparsification pipeline (``ssrg_tpu/configs/config.py:40-47``)."""

    dataset: str = "pubmed"
    dataroot: str = "./datasets/simhomo/"
    seed: int = 2023
    sparse_rate: Tuple[float, float] = (0.6, 0.6)  # (feature_rate, edge_rate)


@dataclass
class DataAugmentConfig:
    """The robust augmentation pipeline (``ssrg_tpu/configs/config.py:50-72``).
    ``l1_weight`` and ``sparse_ce_weight`` weigh the optional L1 (sparse
    against clean logits) and sparse-feature cross-entropy terms; 0 leaves
    only the clean cross entropy, as the reference ships."""

    data_name: str = "pubmed_0.6_0.6"
    data_root: str = "./sparsity_datasets/simhomo/Planetoid"
    data_save_path: str = "./augument_datasets/simhomo/Planetoid/"
    data_split: str = "official"
    dropout: float = 0.5
    weight_decay: float = 5e-4
    hidden_dim: int = 256
    num_layers: int = 3
    batch_size: int = 300
    prop_steps: int = 3
    r: float = 0.5
    degree_level: int = 1
    lr: float = 0.01
    epochs: int = 200
    candidates_per_deficit: int = 100
    l1_weight: float = 0.0
    sparse_ce_weight: float = 0.0


@dataclass
class WaveletConfig:
    """Graph-wavelet (GWNN) settings (``ssrg_tpu/configs/config.py:75-86``)."""

    approximation_order: int = 3
    tolerance: float = 1e-4
    scale: float = 0.5
    impulse_batch: int = 1024
    max_nodes: int = 65_536


@dataclass
class ModelConfig:
    """Model zoo settings (``ssrg_tpu/configs/config.py:89-106``)."""

    model_name: str = "sgc"
    num_layers: int = 3
    dropout: float = 0.5
    hidden_dim: int = 256
    prop_steps: int = 3
    r: float = 0.5            # generalized symmetric-norm exponent
    ppr_alpha: float = 0.1
    message_alpha: float = 0.5
    q: float = 0.05           # magnetic Laplacian phase parameter
    use_bn: bool = False
    edge_mode: str = "concat"
    dtype: str = "float32"    # head compute dtype ("bfloat16" or "float32")
    wavelet: WaveletConfig = field(default_factory=WaveletConfig)


@dataclass
class TrainingConfig:
    """Training loop settings (``ssrg_tpu/configs/config.py:109-142``)."""

    seed: int = 2023
    normalize_times: int = 1
    num_epochs: int = 300
    lr: float = 1e-3
    weight_decay: float = 1e-5
    warmup_epochs: int = 0
    train_batch_size: Optional[int] = None  # None => full-batch
    eval_batch_size: Optional[int] = None
    dtype: str = "float32"
    # auto | dense | coo | ell | hybrid | pallas | banded | tiled | blockcoo
    # | pallas_banded | reorder_banded | reorder_tiled | autotune
    spmm_engine: str = "auto"
    spmm_bf16: bool = False
    cluster_merge_target: int = 0
    mesh_shape: Sequence[int] = ()
    cache_dir: Optional[str] = None  # disk cache for propagated hop features
    checkpoint_path: Optional[str] = None
    resume_from: Optional[str] = None
    scan_epochs: bool = False


@dataclass
class FrameworkConfig:
    """One of each configuration (``ssrg_tpu/configs/config.py:146-154``)."""

    data: DataConfig = field(default_factory=DataConfig)
    data_process: DataProcessConfig = field(default_factory=DataProcessConfig)
    data_augment: DataAugmentConfig = field(default_factory=DataAugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    def replace(self, **kwargs) -> "FrameworkConfig":
        return dataclasses.replace(self, **kwargs)
