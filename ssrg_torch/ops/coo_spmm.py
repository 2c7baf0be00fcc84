"""COO segmented sum: the hand-written CUDA kernel, its plain PyTorch version
and its launch count.

``coo_accumulate(row, col, val, x, out, nnz)`` adds ``val[e] * x[col[e]]``
into ``out[row[e]]`` for the first ``nnz`` entries, in place, and returns
``out``. It carries the COO tail of every hybrid pack
(:class:`ssrg_torch.ops.sparse.COOAdj`, reached from ``HybridAdj``, the
``pallas`` engine's ``PallasELLAdj`` and the ``coo`` engine) and the local
COO terms of :mod:`ssrg_torch.parallel.dist_spmm`. The reference leaves
this term to XLA's ``segment_sum``; no Pallas kernel of it exists.

For CUDA tensors the wrapper launches ``csrc/coo_spmm.cu``, which
:mod:`ssrg_torch.ops._nvcc` builds at first use: one launch gathers, scales
and sums each run of one row in registers and adds it into ``out`` with one
atomic a feature. For CPU tensors it runs :func:`coo_accumulate_plain`, the
chunked ``index_select``, scaling and ``index_add_`` loop. There is no other
path: a CUDA tensor launches the kernel or raises.

The kernel has no gradient of its own and writes ``out`` in place. Autograd
reaches it through :class:`ssrg_torch.ops.sparse.DifferentiableAdj`, whose
backward runs it on the pack of the transposed adjacency; called directly
where a gradient is wanted, the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ssrg_torch.ops import _nvcc

NAME = "coo_spmm"
# the entries the plain version gathers at once, as the packs chunk them
CHUNK = 1 << 19

NO_GRAD = ("the kernel adds into out in place and has no gradient; the gradient of "
           "A @ x is the same kernel on the pack of A^T: use "
           "ops.sparse.differentiable_adjacency")


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.coo_spmm_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def _entries(row: torch.Tensor, nnz: Optional[int]) -> int:
    """The entries a call adds: ``nnz``, or all of them where it is None."""
    return int(row.shape[0]) if nnz is None else int(nnz)


def _check(row, col, val, x, out, nnz: Optional[int]) -> None:
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"coo_accumulate: row and col must be int32, got {row.dtype} and "
                        f"{col.dtype}")
    if val.dtype != torch.float32 or x.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"coo_accumulate: val, x and out must be float32, got {val.dtype}, "
                        f"{x.dtype} and {out.dtype}")
    if row.dim() != 1 or row.shape != col.shape or row.shape != val.shape:
        raise TypeError(f"coo_accumulate: row, col and val must be 1-D of one length, got "
                        f"{tuple(row.shape)}, {tuple(col.shape)} and {tuple(val.shape)}")
    if x.dim() != 2 or out.dim() != 2 or x.shape[1] != out.shape[1]:
        raise TypeError(f"coo_accumulate: x and out must be [*, F] of one F, got "
                        f"{tuple(x.shape)} and {tuple(out.shape)}")
    _nvcc.check_operands("coo_accumulate", row=row, col=col, val=val, x=x, out=out)
    if not 0 <= _entries(row, nnz) <= row.shape[0]:
        raise TypeError(f"coo_accumulate: nnz {nnz} outside [0, {row.shape[0]}]")
    if x.shape[1] >= 2**31:
        raise TypeError("coo_accumulate: F must fit in int32")


def coo_accumulate_plain(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                         x: torch.Tensor, out: torch.Tensor, nnz: Optional[int] = None,
                         chunk: int = CHUNK) -> torch.Tensor:
    """The plain PyTorch version: per ``chunk`` entries an ``index_select``
    of the x rows, a scaling by the values and an ``index_add_`` into
    ``out`` (three launches a chunk on a card), over the first ``nnz``
    entries (all where None)."""
    n = _entries(row, nnz)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        out.index_add_(0, row[s:e], x.index_select(0, col[s:e]) * val[s:e, None])
    return out


def launches(entries: int, chunk: int, device: torch.device) -> int:
    """The launches a call over ``entries`` entries takes on ``device``: the
    kernel's one on a CUDA device, the plain version's three a chunk
    elsewhere, none without entries."""
    if entries == 0:
        return 0
    return 1 if device.type == "cuda" else 3 * -(-entries // chunk)


def coo_accumulate(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor, x: torch.Tensor,
                   out: torch.Tensor, nnz: Optional[int] = None,
                   chunk: int = CHUNK) -> torch.Tensor:
    """``out[row[e]] += val[e] * x[col[e]]`` for ``e < nnz`` (every entry
    where ``nnz`` is None), in place; returns ``out``.

    row, col int32 ``[E]``, val f32 ``[E]``, x f32 ``[M, F]``, out f32
    ``[N, F]``, all contiguous on one device. Every row index must lie in
    ``[0, N)`` and every column index in ``[0, M)``, as the packs of
    :mod:`ssrg_torch.ops.sparse` guarantee; the kernel does not check them.
    Any order of the entries is summed right; row-sorted entries (the packs'
    order) are fast. CUDA tensors go to the kernel (counted in
    ``coo_accumulate.launches``; a call with no entries or F = 0 launches
    nothing), CPU tensors to :func:`coo_accumulate_plain` in ``chunk``
    slices. Asked for a gradient (``val``, ``x`` or ``out`` requiring grad
    while grad mode is on), it raises."""
    _check(row, col, val, x, out, nnz)
    _nvcc.refuse_grad("coo_accumulate", NO_GRAD, val=val, x=x, out=out)
    if x.device.type == "cpu":
        return coo_accumulate_plain(row, col, val, x, out, nnz, chunk)
    n = _entries(row, nnz)
    f = x.shape[1]
    if n == 0 or f == 0:
        return out
    vec4 = int(f % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _nvcc.library(NAME, _declare)
    with torch.cuda.device(x.device):
        err = lib.coo_spmm_f32(row.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
                               out.data_ptr(), n, f, vec4, _nvcc.stream_of(x))
    _nvcc.check_launch(NAME, err)
    coo_accumulate.launches += 1
    return out


coo_accumulate.launches = 0
