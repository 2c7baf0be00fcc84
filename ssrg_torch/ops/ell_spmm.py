"""ELL SpMM: the hand-written CUDA kernel, its plain PyTorch version and its
launch count.

``ell_spmm(cols, vals, x)`` computes ``out[r] = sum_w vals[r, w] *
x[cols[r, w]]`` for every row of the pack, padding rows included. It is the
port of ``ssrg_tpu/ops/pallas_spmm.py::_spmm_kernel`` and carries both
``ELLAdj.spmm`` (the bulk of the hybrid engine, which ``engine="auto"``
picks above 8192 nodes) and ``PallasELLAdj.spmm``.

For CUDA tensors the wrapper launches ``csrc/ell_spmm.cu``, which
:mod:`ssrg_torch.ops._nvcc` builds at first use. The kernel adds only the
nonzero slots (the padding slots, column 0 and weight 0, cost nothing) and
walks the features in tiles of :data:`TILE` floats, every row of one tile
before the next, so that most of the x it gathers from stays in L2. For CPU
tensors the wrapper runs :func:`ell_spmm_plain`, which sums every slot as the
reference does. There is no other path: a CUDA tensor launches the kernel or
raises.

The kernel has no gradient of its own. Autograd reaches it through
:class:`ssrg_torch.ops.sparse.DifferentiableAdj`, whose backward runs this
same kernel on the pack of the transposed adjacency; called directly where a
gradient is wanted, the wrapper raises rather than return an output cut off
from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from ssrg_torch.ops import _nvcc

NAME = "ell_spmm"
# the kernel's feature tile width, kTile in csrc/ell_spmm.cu
TILE = 64

NO_GRAD = ("the kernel's gradient is the same kernel on the transposed pack: "
           "use ops.sparse.differentiable_adjacency (csrc/ell_spmm.cu's note, PERF.md section 6)")

# bytes of gathered neighbour rows the plain version materializes at once
_PLAIN_CHUNK_BYTES = 1 << 26


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ell_spmm_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def _check(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> None:
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmm: cols must be int32, got {cols.dtype}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"ell_spmm: vals and x must be float32, got {vals.dtype} and {x.dtype}"
        )
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise TypeError(
            f"ell_spmm: cols and vals must be [rows, width] of one shape, got "
            f"{tuple(cols.shape)} and {tuple(vals.shape)}"
        )
    if x.dim() != 2:
        raise TypeError(f"ell_spmm: x must be [N, F], got {tuple(x.shape)}")
    _nvcc.check_operands("ell_spmm", cols=cols, vals=vals, x=x)
    if x.shape[0] == 0 and cols.numel():
        raise TypeError("ell_spmm: x has no rows for the pack to index")
    if x.shape[1] >= 2**31 or cols.shape[1] >= 2**31:
        raise TypeError("ell_spmm: width and F must fit in int32")


def ell_spmm_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select`` of the neighbour rows and
    a weighted sum over the width, in row chunks that bound the gathered
    ``[rows, width, F]`` block (``ssrg_tpu/ops/sparse.py:161-179`` chunks the
    same way)."""
    n_rows, width = cols.shape
    f = x.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, width * f * 4))
    for r0 in range(0, n_rows, step):
        c = cols[r0:r0 + step]
        v = vals[r0:r0 + step]
        gathered = x.index_select(0, c.reshape(-1)).view(c.shape[0], width, f)
        out[r0:r0 + step] = torch.einsum("rw,rwf->rf", v, gathered)
    return out


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_w vals[r, w] * x[cols[r, w]]`` for every pack row.

    cols int32 ``[rows, width]``, vals f32 ``[rows, width]``, x f32
    ``[N, F]``, all contiguous on one device; returns f32 ``[rows, F]``.
    Every column index must lie in ``[0, N)``, as the packs of
    :mod:`ssrg_torch.ops.sparse` guarantee; the kernel does not check them.
    CUDA tensors go to the kernel (counted in ``ell_spmm.launches``), CPU
    tensors to :func:`ell_spmm_plain`. Asked for a gradient (``x`` or
    ``vals`` requiring grad while grad mode is on), it raises."""
    _check(cols, vals, x)
    _nvcc.refuse_grad(NAME, NO_GRAD, vals=vals, x=x)
    if x.device.type == "cpu":
        return ell_spmm_plain(cols, vals, x)
    n_rows, width = cols.shape
    f = x.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    if n_rows == 0 or f == 0:
        return out
    if width == 0:
        return out.zero_()
    vec4 = int(f % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _nvcc.library(NAME, _declare)
    with torch.cuda.device(x.device):
        err = lib.ell_spmm_f32(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rows, width, f, vec4, _nvcc.stream_of(x),
        )
    _nvcc.check_launch(NAME, err)
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0
