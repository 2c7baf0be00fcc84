"""GAT edge attention without per-edge messages: the hand-written CUDA
kernels, their plain PyTorch versions, the autograd function over both and
its launch count.

``gat_attention(z, s_src, s_dst, edges, negative_slope)`` computes, for
``z = [N, H, C]`` and the scores ``s_src, s_dst = [N, H]`` over the entries
of ``edges`` (an :class:`ssrg_torch.models.baselines.EdgeList` built with
:meth:`~ssrg_torch.models.baselines.EdgeList.attention`: destination
``row``, source ``col``, sorted by row, and the transposed listing
``t_row``, ``t_col``)::

    a[e, h]      = leaky_relu(s_dst[row_e, h] + s_src[col_e, h])
    alpha[e, h]  = softmax of a over the entries of row_e
    out[i, h, :] = sum over the entries of i of alpha[e, h] * z[col_e, h, :]

and carries gradients to ``z``, ``s_src`` and ``s_dst``. It replaces, for
an attention with no dropout of its weights, the per-edge messages of
``models/baselines.py::BaselineGAT`` (``z[col] * alpha``, ``[E, H, C]``),
which at ogbn-products' size no card holds. The steps, forward and
backward, are those of ``csrc/gat_attention.cu`` (its header gives the
equations): the row maxima and sums (:func:`softmax_stats`), the weighted
sum (:func:`aggregate`), and backward ``delta = <g, out>`` with the row-side
values packed (:func:`rowdot`) and one pass over the transposed listing
(:func:`backward`) that adds ``dz``, ``ds_src`` and ``ds_dst``. Only ``[N,
H]`` statistics are kept; alpha is recomputed wherever it is needed.

For CUDA tensors each step launches its kernel (``gat_stats_kernel`` twice,
``gat_aggregate_kernel``, ``gat_rowdot_kernel``, ``gat_backward_kernel``),
which :mod:`ssrg_torch.ops._nvcc` builds at first use; for CPU tensors it
runs the step's plain version (``softmax_stats_plain``, ``aggregate_plain``,
``rowdot_plain``, ``backward_plain``), which computes the same quantities
with chunked gathers and ``index_add_``. There is no other path: a CUDA tensor
launches the kernels or raises. The forward pass is the span ``attn`` and
the backward pass, on the autograd thread, ``attn.bwd``, both timed on the
stream while a profiler runs; they count ``attn.edges`` (entries),
``attn.heads`` and ``attn.launches`` (kernel launches; 0 on the CPU).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ssrg_torch.logger import count, span
from ssrg_torch.ops import _nvcc

NAME = "gat_attention"
# the widest head the kernels take (a group's tile: 32 lanes of 16 floats)
MAX_HEAD_WIDTH = 512
# entries the plain versions gather at once
CHUNK = 1 << 18
# kernel launches of a forward and of a backward pass on a card
FORWARD_LAUNCHES = 3
BACKWARD_LAUNCHES = 2


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    lib.gat_stats_f32.argtypes = [p, p, p, p, p, p, i64, i32, f32, p]
    lib.gat_aggregate_f32.argtypes = [p, p, p, p, p, p, p, p, i64, i32, i32, f32, i32, p]
    lib.gat_rowdot_f32.argtypes = [p, p, p, p, p, p, i64, i32, i32, p]
    lib.gat_backward_f32.argtypes = [p, p, p, p, p, p, p, p, p, i64, i32, i32, f32, i32, p]
    for fn in (lib.gat_stats_f32, lib.gat_aggregate_f32, lib.gat_rowdot_f32,
               lib.gat_backward_f32):
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _nvcc.library(NAME, _declare)


# each entry point's kernel and its launches a call
KERNELS = {"gat_stats_f32": ("gat_stats_kernel", 2),
           "gat_aggregate_f32": ("gat_aggregate_kernel", 1),
           "gat_rowdot_f32": ("gat_rowdot_kernel", 1),
           "gat_backward_f32": ("gat_backward_kernel", 1)}


def _launch(entry: str, *args) -> None:
    _nvcc.check_launch(NAME, getattr(_lib(), entry)(*args))
    kernel, n = KERNELS[entry]
    gat_attention.launches += n
    gat_attention.kernel_launches[kernel] += n


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _leaky(p: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(p, slope)


def _check(z: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor, edges) -> None:
    if z.dim() != 3:
        raise TypeError(f"gat_attention: z must be [N, H, C], got {tuple(z.shape)}")
    n, h, c = z.shape
    for name, s in (("s_src", s_src), ("s_dst", s_dst)):
        if tuple(s.shape) != (n, h):
            raise TypeError(f"gat_attention: {name} must be [{n}, {h}], got {tuple(s.shape)}")
    if z.dtype != torch.float32 or s_src.dtype != torch.float32 or s_dst.dtype != torch.float32:
        raise TypeError("gat_attention: z, s_src and s_dst must be float32")
    if edges.t_row is None or edges.nnz is None:
        raise TypeError("gat_attention: edges must carry the transposed listing "
                        "(EdgeList.attention)")
    if edges.num_nodes != n:
        raise TypeError(f"gat_attention: edges of {edges.num_nodes} nodes, z of {n}")
    for name in ("row", "col", "t_row", "t_col"):
        if getattr(edges, name).dtype != torch.int32:
            raise TypeError(f"gat_attention: edges.{name} must be int32")
    if z.device.type == "cuda" and c > MAX_HEAD_WIDTH:
        raise TypeError(f"gat_attention: a head of {c} features; the kernels take at most "
                        f"{MAX_HEAD_WIDTH}")
    _nvcc.check_operands(NAME, z=z, s_src=s_src, s_dst=s_dst, row=edges.row, col=edges.col,
                         t_row=edges.t_row, t_col=edges.t_col)


# -- the steps: each a plain version, and a wrapper that takes it for CPU
# tensors and launches the step's kernel for CUDA ones ------------------------


def softmax_stats_plain(row, col, s_src, s_dst, nnz: int, slope: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row maxima ``m`` and sums ``l`` of the attention's softmax over
    the first ``nnz`` entries, ``CHUNK`` entries at a time: ``[N, H]`` each;
    a row without entries keeps ``-inf`` and 0."""
    m = torch.full_like(s_src, float("-inf"))
    l = torch.zeros_like(s_src)
    for s in range(0, nnz, CHUNK):
        r, c = row[s:min(s + CHUNK, nnz)].long(), col[s:min(s + CHUNK, nnz)].long()
        a = _leaky(s_dst[r] + s_src[c], slope)
        m.scatter_reduce_(0, r[:, None].expand_as(a), a, "amax", include_self=True)
    for s in range(0, nnz, CHUNK):
        r, c = row[s:min(s + CHUNK, nnz)].long(), col[s:min(s + CHUNK, nnz)].long()
        l.index_add_(0, r, torch.exp(_leaky(s_dst[r] + s_src[c], slope) - m[r]))
    return m, l


def softmax_stats(row, col, s_src, s_dst, nnz: int, slope: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`softmax_stats_plain` on its kernel (two launches) for CUDA
    tensors."""
    if s_src.device.type != "cuda":
        return softmax_stats_plain(row, col, s_src, s_dst, nnz, slope)
    m = torch.full_like(s_src, float("-inf"))
    l = torch.zeros_like(s_src)
    if nnz:
        with torch.cuda.device(s_src.device):
            _launch("gat_stats_f32", row.data_ptr(), col.data_ptr(), s_src.data_ptr(),
                    s_dst.data_ptr(), m.data_ptr(), l.data_ptr(), nnz, s_src.shape[1], slope,
                    _nvcc.stream_of(s_src))
    return m, l


def _step(z: torch.Tensor) -> int:
    """Entries a plain version gathers at once: ``CHUNK`` at 128 features."""
    return max(1, CHUNK * 128 // max(1, z.shape[1] * z.shape[2]))


def aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz: int, slope: float) -> torch.Tensor:
    """``out[i, h, :] = sum of alpha[e, h] * z[col_e, h, :]`` over the first
    ``nnz`` entries: ``[N, H, C]``."""
    out = torch.zeros_like(z)
    step = _step(z)
    for s in range(0, nnz, step):
        r, c = row[s:min(s + step, nnz)].long(), col[s:min(s + step, nnz)].long()
        w = torch.exp(_leaky(s_dst[r] + s_src[c], slope) - m[r]) / l[r]
        out.index_add_(0, r, z[c] * w[..., None])
    return out


def aggregate(row, col, s_src, s_dst, m, l, z, nnz: int, slope: float) -> torch.Tensor:
    """:func:`aggregate_plain` on its kernel for CUDA tensors."""
    if z.device.type != "cuda":
        return aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz, slope)
    out = torch.zeros_like(z)
    n, h, c = z.shape
    if nnz and c:
        with torch.cuda.device(z.device):
            _launch("gat_aggregate_f32", row.data_ptr(), col.data_ptr(), s_src.data_ptr(),
                    s_dst.data_ptr(), m.data_ptr(), l.data_ptr(), z.data_ptr(), out.data_ptr(),
                    nnz, h, c, slope, int(c % 4 == 0) & _aligned(z, out),
                    _nvcc.stream_of(z))
    return out


def rowdot_plain(g, out, s_dst, m, l) -> torch.Tensor:
    """The row-side values of the backward pass, ``[N, H, 4]``: ``s_dst``,
    ``m``, ``l`` and ``delta = <g[i, h, :], out[i, h, :]>``."""
    return torch.stack([s_dst, m, l, (g * out).sum(-1)], dim=-1)


def rowdot(g, out, s_dst, m, l) -> torch.Tensor:
    """:func:`rowdot_plain` on its kernel for CUDA tensors."""
    if g.device.type != "cuda":
        return rowdot_plain(g, out, s_dst, m, l)
    n, h, c = g.shape
    q = torch.empty((n, h, 4), dtype=torch.float32, device=g.device)
    if n:
        with torch.cuda.device(g.device):
            _launch("gat_rowdot_f32", g.data_ptr(), out.data_ptr(), s_dst.data_ptr(),
                    m.data_ptr(), l.data_ptr(), q.data_ptr(), n, h, c, _nvcc.stream_of(g))
    return q


def backward_plain(t_row, t_col, q, s_src, z, g, nnz: int, slope: float):
    """One pass over the transposed listing (source ``t_row``, destination
    ``t_col``): ``dz[j] = sum of alpha * g[i]``, ``ds_src[j]`` and
    ``ds_dst[i]`` the sums of ``dpre = alpha * (<g[i], z[j]> - delta[i]) *
    leaky_relu'(pre)`` over the entries, each head on its own."""
    dz = torch.zeros_like(z)
    ds_src = torch.zeros_like(s_src)
    ds_dst = torch.zeros_like(s_src)
    step = _step(z)
    for s in range(0, nnz, step):
        j, i = t_row[s:min(s + step, nnz)].long(), t_col[s:min(s + step, nnz)].long()
        sd, mi, li, delta = q[i].unbind(-1)
        pre = sd + s_src[j]
        w = torch.exp(_leaky(pre, slope) - mi) / li
        gi = g[i]
        dz.index_add_(0, j, gi * w[..., None])
        dpre = w * ((gi * z[j]).sum(-1) - delta) * torch.where(pre > 0, 1.0, slope)
        ds_src.index_add_(0, j, dpre)
        ds_dst.index_add_(0, i, dpre)
    return dz, ds_src, ds_dst


def backward(t_row, t_col, q, s_src, z, g, nnz: int, slope: float):
    """:func:`backward_plain` on its kernel for CUDA tensors:
    ``(dz, ds_src, ds_dst)``."""
    if z.device.type != "cuda":
        return backward_plain(t_row, t_col, q, s_src, z, g, nnz, slope)
    n, h, c = z.shape
    dz = torch.zeros_like(z)
    ds_src = torch.zeros_like(s_src)
    ds_dst = torch.zeros_like(s_src)
    if nnz and c:
        with torch.cuda.device(z.device):
            _launch("gat_backward_f32", t_row.data_ptr(), t_col.data_ptr(), s_src.data_ptr(),
                    q.data_ptr(), z.data_ptr(), g.data_ptr(), dz.data_ptr(), ds_src.data_ptr(),
                    ds_dst.data_ptr(), nnz, h, c, slope, int(c % 4 == 0) & _aligned(z, g, dz),
                    _nvcc.stream_of(z))
    return dz, ds_src, ds_dst


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, s_src, s_dst, edges, slope):
        out, m, l = _forward(z, s_src, s_dst, edges, slope)
        ctx.edges, ctx.slope = edges, slope
        ctx.save_for_backward(z, s_src, s_dst, m, l, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        z, s_src, s_dst, m, l, out = ctx.saved_tensors
        e = ctx.edges
        with span("attn.bwd", device=True):
            _counts(e, z)
            launches = gat_attention.launches
            g = grad_out.contiguous()
            q = rowdot(g, out, s_dst, m, l)
            dz, ds_src, ds_dst = backward(e.t_row, e.t_col, q, s_src, z, g, e.nnz, ctx.slope)
            count("attn.launches", gat_attention.launches - launches)
        return dz, ds_src, ds_dst, None, None


def _counts(edges, z) -> None:
    count("attn.edges", int(edges.nnz))
    count("attn.heads", int(z.shape[1]))


def _forward(z, s_src, s_dst, edges, slope):
    with span("attn", device=True):
        _counts(edges, z)
        launches = gat_attention.launches
        m, l = softmax_stats(edges.row, edges.col, s_src, s_dst, edges.nnz, slope)
        out = aggregate(edges.row, edges.col, s_src, s_dst, m, l, z, edges.nnz, slope)
        count("attn.launches", gat_attention.launches - launches)
    return out, m, l


def gat_attention(z: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor, edges,
                  negative_slope: float = 0.2) -> torch.Tensor:
    """The attention-weighted sum ``[N, H, C]`` of ``z`` over ``edges``, with
    gradients to ``z``, ``s_src`` and ``s_dst`` where grad mode wants them.
    CUDA tensors run the kernels (counted in ``gat_attention.launches``:
    three a forward pass, two a backward; by kernel in
    ``gat_attention.kernel_launches``), CPU tensors the plain versions."""
    z, s_src, s_dst = z.contiguous(), s_src.contiguous(), s_dst.contiguous()
    _check(z, s_src, s_dst, edges)
    slope = float(negative_slope)
    if torch.is_grad_enabled() and (z.requires_grad or s_src.requires_grad
                                    or s_dst.requires_grad):
        return _GATAttention.apply(z, s_src, s_dst, edges, slope)
    return _forward(z, s_src, s_dst, edges, slope)[0]


gat_attention.launches = 0
gat_attention.kernel_launches = dict.fromkeys((k for k, _ in KERNELS.values()), 0)
