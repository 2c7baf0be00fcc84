"""Model and training configuration.

Same fields and defaults as ``ssrg_tpu/configs/config.py`` (``ModelConfig``,
``TrainingConfig`` and the ``WaveletConfig`` that ``ModelConfig`` holds), so
one set of settings drives either package. Fields that select paths this
port does not run yet are kept and refused where they are read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


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
