"""ssrg_torch — the PyTorch/CUDA port of ``ssrg_tpu`` for NVIDIA Hopper.

The JAX package ``ssrg_tpu`` is the reference; every module here mirrors the
module of the same path there and is held against it by the
``tests/test_torch_port_*.py`` parity tests. This package imports torch,
numpy and scipy only — never jax, flax, optax or ``ssrg_tpu``.

Ported: normalization, hybrid ELL+COO packing, K-hop propagation through
the hand-written CUDA ELL SpMM kernel (``csrc/ell_spmm.cu``), the locality
engines on the banded and rest kernels, the message operators, the heads,
the model zoo's precompute models and naive GCN, training
(:class:`ssrg_torch.train.NodeClassification`, with the ELL kernel under
autograd for the GCN), checkpoints and :class:`ssrg_torch.serve.Predictor`,
the host graph builders on an OpenMP C++ library (:mod:`ssrg_torch.native`,
``csrc/graphbuild.cpp``), the K-hop bench (:mod:`ssrg_torch.bench`), the
logger with its ``torch.profiler`` trace (:mod:`ssrg_torch.logger`), the
dataset loaders (:mod:`ssrg_torch.data`), the robustness pipeline
(:mod:`ssrg_torch.pipelines`: sparsify, then repair features and edges),
link classification (:class:`ssrg_torch.train.LinkClassification`), the
message-passing baselines (:class:`ssrg_torch.train.BaselineTask`),
single-card out-of-core propagation and training
(:mod:`ssrg_torch.parallel.outofcore`, :mod:`ssrg_torch.train.outofcore_task`)
and the distributed tier on ``torch.distributed``
(:mod:`ssrg_torch.parallel.dist_spmm`, :mod:`ssrg_torch.parallel.dist_train`,
:mod:`ssrg_torch.parallel.multihost`), and the command line
(:mod:`ssrg_torch.cli`, ``ssrg-torch``): every module of ``ssrg_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line).
"""

__version__ = "0.1.0"

from ssrg_torch.configs.config import (  # noqa: F401
    DataConfig,
    FrameworkConfig,
    ModelConfig,
    TrainingConfig,
    WaveletConfig,
)


def load_model(*args, **kwargs):
    """Re-export of :func:`ssrg_torch.models.zoo.load_model`."""
    from ssrg_torch.models.zoo import load_model as _load_model

    return _load_model(*args, **kwargs)


def Predictor(*args, **kwargs):
    """Re-export of :class:`ssrg_torch.serve.Predictor`."""
    from ssrg_torch.serve import Predictor as _Predictor

    return _Predictor(*args, **kwargs)
