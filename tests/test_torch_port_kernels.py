"""The ELL SpMM wrapper of ``ssrg_torch``: its plain version against a
float64 numpy product on ragged packs, its refusals, and, on a CUDA card,
the hand-written kernel against the plain version.

This file imports neither jax nor ``ssrg_tpu``, so the ``cuda``-marked
tests also run where only the port is installed:

    python -m pytest tests/test_torch_port_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_torch.ops import sparse
from ssrg_torch.ops.ell_spmm import ell_spmm, ell_spmm_plain

ELL_CASES = [  # (rows, n, width, f, empty_fraction)
    (37, 50, 1, 128, 0.0),
    (1003, 777, 7, 50, 0.1),
    (61, 40, 40, 300, 0.2),
    (13, 20, 3, 48, 0.5),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ELL SpMM kernel runs only there")
    return torch.device("cuda")


def _ell_case(rows, n, width, f, empty, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (rows, width)).astype(np.int32)
    vals = rng.normal(size=(rows, width)).astype(np.float32)
    drop = rng.uniform(size=rows) < empty
    cols[drop], vals[drop] = 0, 0.0
    x = rng.normal(size=(n, f)).astype(np.float32)
    dense = np.zeros((rows, n))
    np.add.at(dense, (np.repeat(np.arange(rows), width), cols.reshape(-1)), vals.reshape(-1))
    return cols, vals, x, dense @ x.astype(np.float64)


@pytest.mark.parametrize("case", ELL_CASES, ids=lambda c: "r{}_n{}_w{}_f{}".format(*c))
def test_ell_spmm_plain_ragged(case):
    cols, vals, x, expected = _ell_case(*case)
    before = ell_spmm.launches
    out = ell_spmm(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x))
    assert ell_spmm.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(out.numpy(), expected, rtol=3e-5, atol=3e-5)


def test_ell_spmm_refuses_what_the_kernel_does_not_take():
    cols, vals, x, _ = _ell_case(16, 20, 4, 8, 0.0)
    c, v, xx = torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x)
    with pytest.raises(TypeError):
        ell_spmm(c.long(), v, xx)
    with pytest.raises(TypeError):
        ell_spmm(c, v, xx.double())
    with pytest.raises(ValueError):
        ell_spmm(c, v[:, :3].contiguous(), xx)
    with pytest.raises(ValueError):
        ell_spmm(c, v, xx.t())  # not contiguous
    with pytest.raises(ValueError):
        ell_spmm(c, v, torch.empty(20, 8, device="meta"))
    with pytest.raises(ValueError):
        sparse.build_ell(sp.random(20, 20, 0.2, format="csr", random_state=0)).spmm(xx[:10])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ELL_CASES, ids=lambda c: "r{}_n{}_w{}_f{}".format(*c))
def test_ell_spmm_kernel_matches_plain(cuda_device, case):
    cols, vals, x, _ = _ell_case(*case)
    c, v, xx = (torch.from_numpy(a).to(cuda_device) for a in (cols, vals, x))
    before = ell_spmm.launches
    out = ell_spmm(c, v, xx)
    torch.cuda.synchronize()
    assert ell_spmm.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ell_spmm_plain(c, v, xx).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
