"""The banded product of bf16 packs, the tensor-core path's function, held
to ``ssrg_tpu``'s ``PallasBandedAdj`` on the CPU.

The bench's banded tier (``bench.banded_tier_inputs`` at its CPU size: 2
dense bf16 blocks of 512 x 1,024) goes through the port's
``PallasBandedAdj(window_bf16=True)`` (on the CPU, the plain version of
``ops/banded_spmm.py``) and through the reference's, whose Pallas kernel
``_banded_kernel`` runs in interpret mode as ``tests/test_pallas_banded.py``
runs it. Both round x to bf16 and take exact bf16 x bf16 products summed in
f32, in other orders: each within W * 2^-24 * sum|a * x| of the exact sum,
so they differ by at most 2 * W * 2^-24 * sum|a * x| elementwise (W = 1,024
products a row). The card's kernel is held to the plain version in
``tests/test_torch_port_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrg_tpu.ops.pallas_banded import PallasBandedAdj as RefPallasBandedAdj

from ssrg_torch import bench
from ssrg_torch.ops import banded_spmm as banded_spmm_module
from ssrg_torch.ops.pallas_banded import PallasBandedAdj

UNIT_ROUNDOFF = 2.0 ** -24


def _both(blocks, los, x):
    nb, rb, _ = blocks.shape
    n = x.shape[0]
    got = PallasBandedAdj(blocks, los, n, n, rb, window_bf16=True).spmm(x).numpy()
    ref_blocks = jnp.asarray(blocks.float().numpy(), dtype=jnp.bfloat16)
    ref = RefPallasBandedAdj(ref_blocks, jnp.asarray(los.numpy()), n, n, rb, interpret=True,
                             window_bf16=True).spmm(jnp.asarray(x.numpy()))
    return got, np.asarray(ref)


def _bound(blocks, los, x):
    """2 * W * 2^-24 * (|A| |bf16(x)|), from the plain version on |A| and |x|."""
    w = blocks.shape[2]
    magnitude = banded_spmm_module.banded_spmm_plain(blocks.abs(), los, x.abs(), True)
    return 2.0 * w * UNIT_ROUNDOFF * magnitude.numpy()


@pytest.mark.parametrize("f", [16, 40])
def test_bench_banded_tier_matches_reference(f):
    blocks, los, x = bench.banded_tier_inputs(f, device="cpu")
    assert banded_spmm_module.path(blocks) == "tensor_core"
    got, ref = _both(blocks, los, x)
    assert got.shape == ref.shape == (x.shape[0], f)
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - ref) <= _bound(blocks, los, x) + 1e-30)


def test_inf_under_a_zero_entry_gives_nan_as_in_the_reference():
    """Block 0's window column k is zeroed and x holds +Inf at that window
    row's feature 0: the dense product of the reference gives 0 * Inf = NaN
    in every row of block 0 at feature 0, and so does the port. Where other
    blocks multiply the Inf by nonzero entries both give an Inf or a NaN at
    the same places; every finite output is within the bound above."""
    blocks, los, x = bench.banded_tier_inputs(16, device="cpu")
    rb = blocks.shape[1]
    k = 37
    blocks[0, :, k] = 0
    x[int(los[0]) + k, 0] = float("inf")
    got, ref = _both(blocks, los, x)
    assert np.isnan(got[:rb, 0]).all() and np.isnan(ref[:rb, 0]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    assert finite[:, 1:].all()
    bound = _bound(blocks, los, x.nan_to_num(posinf=0.0))
    assert np.all(np.abs(got[finite] - ref[finite]) <= bound[finite] + 1e-30)
