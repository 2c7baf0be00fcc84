"""Rest SpMM: the hand-written CUDA kernel, its plain PyTorch version and its
launch count.

``rest_spmm(row_ptr, row_end, cols, vals, x, gather_bf16)`` computes, for
every output row ``r``, the sum over the layout entries ``e`` in
``[row_ptr[r], row_end[r])`` of ``vals[e] * x[cols[e]]``; with
``gather_bf16`` each term is ``bf16(bf16(x[cols[e]]) * bf16(vals[e]))``, the
reference's rounding points; sums are f32. ``build_rest_segmented`` sets
``row_end`` so that no row's range holds a pad entry. It is the port of
``ssrg_tpu/ops/pallas_rest.py::_rest_kernel`` with the gather fused in, and
carries ``RestSegmentedAdj.spmm_pallas``: the scattered rest of
``spmm_engine="reorder_tiled"`` with ``spmm_bf16`` on the card.

For CUDA tensors the wrapper launches ``csrc/rest_spmm.cu``, which
:mod:`ssrg_torch.ops._nvcc` builds at first use. For CPU tensors it runs
:func:`rest_spmm_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ssrg_torch.ops import _nvcc

NAME = "rest_spmm"

# entries whose gathered rows the plain version materializes at once
_PLAIN_CHUNK = 1 << 18


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.rest_spmm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def _check(row_ptr, row_end, cols, vals, x) -> None:
    if row_ptr.dtype != torch.int64 or row_end.dtype != torch.int64 or cols.dtype != torch.int32:
        raise TypeError(
            f"rest_spmm: row_ptr and row_end must be int64 and cols int32, got "
            f"{row_ptr.dtype}, {row_end.dtype} and {cols.dtype}"
        )
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"rest_spmm: vals and x must be float32, got {vals.dtype} and {x.dtype}"
        )
    if (row_ptr.dim() != 1 or row_ptr.shape[0] < 1 or row_end.shape != (row_ptr.shape[0] - 1,)
            or cols.shape != vals.shape):
        raise TypeError(
            f"rest_spmm: row_ptr must be [rows + 1], row_end [rows] and cols, vals one "
            f"shape, got {tuple(row_ptr.shape)}, {tuple(row_end.shape)}, "
            f"{tuple(cols.shape)} and {tuple(vals.shape)}"
        )
    if x.dim() != 2:
        raise TypeError(f"rest_spmm: x must be [N, F], got {tuple(x.shape)}")
    _nvcc.check_operands("rest_spmm", row_ptr=row_ptr, row_end=row_end, cols=cols, vals=vals,
                         x=x)
    if x.shape[1] >= 2**31:
        raise TypeError("rest_spmm: F must fit in int32")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def rest_spmm_plain(row_ptr: torch.Tensor, row_end: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, x: torch.Tensor, gather_bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the row of every entry from ``row_ptr``,
    the entries before their row's ``row_end`` kept, the scaled neighbour
    rows by ``index_select``, and ``index_add_`` into the output, in chunks
    of entries."""
    n_rows = row_ptr.shape[0] - 1
    f = x.shape[1]
    out = torch.zeros((n_rows, f), dtype=torch.float32, device=x.device)
    end = int(row_ptr[-1])
    row_of = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), row_ptr.diff(), output_size=end)
    cols, vals = cols.reshape(-1)[:end], vals.reshape(-1)[:end]
    for s in range(0, end, _PLAIN_CHUNK):
        c, v, r = cols[s:s + _PLAIN_CHUNK], vals[s:s + _PLAIN_CHUNK], row_of[s:s + _PLAIN_CHUNK]
        pos = torch.arange(s, s + r.shape[0], device=x.device)
        keep = pos < row_end[r]                          # drop each row's tail past row_end
        c, v, r = c[keep], v[keep], r[keep]
        g = x.index_select(0, c)
        if gather_bf16:
            g = _bf16(_bf16(g) * _bf16(v)[:, None])
        else:
            g = g * v[:, None]
        out.index_add_(0, r, g)
    return out


NO_GRAD = ("the rest kernel is forward-only, as the reference's _rest_kernel "
           "(csrc/rest_spmm.cu's note, PERF.md section 6); differentiate through the dense or "
           "hybrid engine")


def rest_spmm(row_ptr: torch.Tensor, row_end: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, gather_bf16: bool = False) -> torch.Tensor:
    """``out[r] = sum_{e in [row_ptr[r], row_end[r])} vals[e] * x[cols[e]]``.

    row_ptr int64 ``[rows + 1]`` (non-decreasing, from 0 to at most the
    layout size), row_end int64 ``[rows]`` (``row_ptr[r] <= row_end[r] <=
    row_ptr[r+1]``), cols int32 and vals f32 of one shape (the flat layout),
    x f32 ``[N, F]``, all contiguous on one device; returns f32 ``[rows,
    F]``. Column indices in the rows' ranges must lie in ``[0, N)``, as
    ``build_rest_segmented`` guarantees; the kernel does not check them.
    CUDA tensors go to the kernel (counted in ``rest_spmm.launches``), CPU
    tensors to :func:`rest_spmm_plain`. Forward only, as the reference's
    kernel: asked for a gradient, it raises."""
    _check(row_ptr, row_end, cols, vals, x)
    _nvcc.refuse_grad(NAME, NO_GRAD, vals=vals, x=x)
    if x.device.type == "cpu":
        return rest_spmm_plain(row_ptr, row_end, cols, vals, x, gather_bf16)
    n_rows = row_ptr.shape[0] - 1
    f = x.shape[1]
    out = torch.empty((n_rows, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _nvcc.library(NAME, _declare)
    with torch.cuda.device(x.device):
        err = lib.rest_spmm(
            row_ptr.data_ptr(), row_end.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            x.data_ptr(), out.data_ptr(), n_rows, f, int(gather_bf16), _nvcc.stream_of(x),
        )
    _nvcc.check_launch(NAME, err)
    rest_spmm.launches += 1
    return out


rest_spmm.launches = 0
