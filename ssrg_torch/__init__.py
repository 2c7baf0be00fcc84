"""ssrg_torch — the PyTorch/CUDA port of ``ssrg_tpu`` for NVIDIA Hopper.

The JAX package ``ssrg_tpu`` is the reference; every module here mirrors the
module of the same path there and is held against it by the
``tests/test_torch_port_*.py`` parity tests. This package imports torch,
numpy and scipy only — never jax, flax, optax or ``ssrg_tpu``.

The serving path is ported: normalization, hybrid ELL+COO packing, K-hop
propagation through the hand-written CUDA ELL SpMM kernel
(``csrc/ell_spmm.cu``), the message operators, the heads, the model zoo's
precompute models and :class:`ssrg_torch.serve.Predictor`. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from ssrg_torch.configs.config import ModelConfig, TrainingConfig  # noqa: F401
