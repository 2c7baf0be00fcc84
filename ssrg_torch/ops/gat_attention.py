"""Edge attention without per-edge messages: GAT's (node scores), its
scores, and the graph-transformer's (per-edge scores, UniMP's): the
hand-written CUDA kernels, their plain PyTorch versions, the autograd
functions over both and their launch counts.

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
``attn.heads``, ``attn.launches`` (kernel launches; 0 on the CPU) and
``attn.row_launches`` (those of the whole-row path).

The weighted sum and the backward pass take one of two layouts on a card,
by the shape (:func:`layout`). Per head: a group of lanes gathers one
head's C features of an entry's row, the head on the grid's y, in float4
lanes where a head is whole float4s (C = 128). Whole row: where a head is
not whole float4s (C = 47, the last layer's classes) but the row of all H
heads is (H C % 4 == 0), holds at most ``ROW_MAX_HEADS`` heads and
``ROW_MAX_FLOATS`` floats, and z, out, g and dz are 16-byte aligned, a
group gathers the whole row in float4 lanes, each float taking its head's
weight, and fetches an entry's indices and statistics once for all heads.
The path's constants (32-lane groups, 8 entries requested before any is
added, registers capped so that an SM holds 4 blocks) were chosen by timing
``tools/kernels.py``'s variants on the GAT cell's listing (``PERF.md``). Its
launches count by name in ``gat_attention.kernel_launches[ROW_PATH]``.

With a ``mask`` (bool ``[H, E]`` by the row listing's entries, drawn at
``rate``) the weighted sum and the backward pass drop the weights it does
not keep and scale the others by ``1 / (1 - rate)``: on a card the
per-head instances that read the mask (``gat_aggregate_f32`` and
``gat_backward_f32`` in mode ``NODE_MASKED``; the backward pass finds an
entry's mask by its place, :meth:`EdgeList.positions`). Without one, GAT's
instances run as they were; ``attn.masked`` counts the mask's entries a
pass applies.

``dot_attention(q, k, v, edges, mask, rate)`` is the graph-transformer
attention (PyG's ``TransformerConv``): per-edge scores ``s = <q[i], k[j]>
/ sqrt(C)`` (:func:`edge_sddmm`, ``sddmm_kernel``; the plain version is
:func:`ssrg_torch.ops.sddmm.sddmm` a head at a time), their softmax
statistics (:func:`edge_stats`, the stats kernel on ``s``), the weighted
sum of v with the mask applied after the normalization
(:func:`edge_aggregate`); backward ``delta`` (:func:`rowdot`), one pass
over the transposed listing for dv and ``ds = alpha (mask dalpha / (1 -
rate) - delta)`` (:func:`edge_backward`), and the weighted sums of ``ds``
for dq over the rows and dk over the transposed listing
(:func:`weighted_sum`). Per-edge arrays are ``[H, E]``; nothing of ``[E,
H, C]`` is formed. Its spans are ``attn`` and ``attn.bwd``, holding
``attn.qk`` and ``attn.qk.bwd`` (the scores and their gradient, which
count ``attn.qk_launches``). Rows without entries (a listing without
self-loops) give 0.

``gat_scores(z, a_src, a_dst)`` computes the scores the attention takes,
``s_src[n, h] = <z[n, h, :], a_src[h, :]>`` and ``s_dst`` likewise, with
gradients to ``z``, ``a_src`` and ``a_dst``. For CUDA tensors the forward
pass is ``gat_scores_kernel`` (:func:`scores`) and the backward pass
``gat_score_grad_kernel`` then ``gat_score_sum_kernel`` (:func:`score_grad`:
the scores' share of ``dz``, and ``da_src``, ``da_dst`` summed in a fixed
order), each reading z once; the spans ``attn.scores`` and, on the autograd
thread, ``attn.scores.bwd``, both outside ``attn`` and ``attn.bwd``, count
``attn.score_launches``. CPU tensors take ``(z * a).sum(-1)`` for each score
(:func:`scores_plain`) under PyTorch's own autograd, in the span
``attn.scores`` (0 launches). The score kernels count in
``gat_scores.launches`` and, by name, in ``gat_attention.kernel_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ssrg_torch.logger import count, span
from ssrg_torch.ops import _nvcc
from ssrg_torch.ops.sddmm import sddmm

NAME = "gat_attention"
# the widest head the kernels take (a group's tile: 32 lanes of 16 floats)
MAX_HEAD_WIDTH = 512
# the whole-row path: the longest row (heads times width) and the most heads
# it takes (csrc: kRowFloats, kRowHeads)
ROW_MAX_FLOATS = 512
ROW_MAX_HEADS = 8
# the layouts of the weighted sum and the backward pass (csrc: the entries'
# layout argument), and the whole-row path's key in kernel_launches
PER_HEAD_SCALAR, PER_HEAD_FLOAT4, WHOLE_ROW = 0, 1, 2
ROW_PATH = "whole_row"
# the weights' modes of the weighted sum and the backward pass (csrc: kMode): GAT's
# node scores, GAT's node scores with the weights dropped, per-edge scores, per-edge
# weights as given
NODE_SCORES, NODE_MASKED, EDGE_SCORES, EDGE_WEIGHTS = 0, 1, 2, 3
# entries the plain versions gather at once
CHUNK = 1 << 18
# kernel launches of a forward and of a backward pass on a card
FORWARD_LAUNCHES = 3
BACKWARD_LAUNCHES = 2
# ... and of the scores'
SCORE_FORWARD_LAUNCHES = 1
SCORE_BACKWARD_LAUNCHES = 2
# the most blocks of the score gradient an SM holds at once (2,048 threads of
# 128-thread blocks): each keeps a partial row of da in the scratch the wrapper
# allocates
SCORE_MAX_BLOCKS_PER_SM = 16


def _signatures() -> dict:
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    return {"gat_stats_f32": [p, p, p, p, p, p, p, i64, i32, f32, p],
            "gat_aggregate_f32": [p, p, p, p, p, p, p, p, p, f32, p, p, i64, i32, i32, f32,
                                  i32, i32, p],
            "gat_rowdot_f32": [p, p, p, p, p, p, i64, i32, i32, p],
            "gat_backward_f32": [p, p, p, p, p, p, p, f32, p, p, p, p, p, p, f32, i64, i32, i32,
                                 f32, i32, i32, p],
            "gat_scores_f32": [p, p, p, p, p, i64, i32, i32, i32, p],
            "gat_score_grad_f32": [p, p, p, p, p, p, p, i32, p, p, i64, i32, i32, i32, p],
            "edge_sddmm_f32": [p, p, p, p, p, i64, i32, i32, f32, i32, p]}


def _declare(lib: ctypes.CDLL, entries=None) -> None:
    """Set the argument and result types of ``lib``'s C entries (``entries``:
    those named; by default every one)."""
    sig = _signatures()
    for name in entries or sig:
        fn = getattr(lib, name)
        fn.argtypes = sig[name]
        fn.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _nvcc.library(NAME, _declare)


# each entry point's kernels and their launches a call
KERNELS = {"gat_stats_f32": {"gat_stats_kernel": 2},
           "gat_aggregate_f32": {"gat_aggregate_kernel": 1},
           "gat_rowdot_f32": {"gat_rowdot_kernel": 1},
           "gat_backward_f32": {"gat_backward_kernel": 1},
           "gat_scores_f32": {"gat_scores_kernel": 1},
           "gat_score_grad_f32": {"gat_score_grad_kernel": 1, "gat_score_sum_kernel": 1},
           "edge_sddmm_f32": {"sddmm_kernel": 1}}


SCORE_ENTRIES = ("gat_scores_f32", "gat_score_grad_f32")


def _launch(entry: str, *args) -> None:
    """Call ``entry``; count its launches (in ``gat_scores.launches`` for
    the scores', ``gat_attention.launches`` for the others') and its
    kernels' by name."""
    _nvcc.check_launch(NAME, getattr(_lib(), entry)(*args))
    for kernel, n in KERNELS[entry].items():
        gat_attention.kernel_launches[kernel] += n
    (gat_scores if entry in SCORE_ENTRIES else gat_attention).launches += sum(
        KERNELS[entry].values())


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def layout(heads: int, c_head: int, aligned: bool) -> int:
    """The layout of the weighted sum and the backward pass for ``heads``
    heads of ``c_head`` features, ``aligned`` when z, out, g and dz are
    16-byte aligned: ``WHOLE_ROW`` where a head is not whole float4s but
    the row is and the path holds it, else per head, ``PER_HEAD_FLOAT4``
    where a head is whole float4s and ``PER_HEAD_SCALAR`` otherwise."""
    if not aligned:
        return PER_HEAD_SCALAR
    if c_head % 4 == 0:
        return PER_HEAD_FLOAT4
    if ((heads * c_head) % 4 == 0 and heads <= ROW_MAX_HEADS
            and heads * c_head <= ROW_MAX_FLOATS):
        return WHOLE_ROW
    return PER_HEAD_SCALAR


def _layout(z: torch.Tensor, *tensors: torch.Tensor) -> int:
    """:func:`layout` for ``z`` and the step's other ``[N, H, C]`` operands,
    a whole-row launch counted under ``ROW_PATH``."""
    lay = layout(z.shape[1], z.shape[2], bool(_aligned(z, *tensors)))
    gat_attention.kernel_launches[ROW_PATH] += lay == WHOLE_ROW
    return lay


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
                    s_dst.data_ptr(), None, m.data_ptr(), l.data_ptr(), nnz, s_src.shape[1],
                    slope, _nvcc.stream_of(s_src))
    return m, l


def _step(z: torch.Tensor) -> int:
    """Entries a plain version gathers at once: ``CHUNK`` at 128 features."""
    return max(1, CHUNK * 128 // max(1, z.shape[1] * z.shape[2]))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kept(mask, x: torch.Tensor, keep: float):
    """The factor of the entries at places ``x`` (``[n, H]``): ``keep`` where
    the mask ``[H, E]`` keeps the weight, 0 where it drops it; 1 without a
    mask."""
    if mask is None:
        return 1.0
    return mask[:, x].T.to(torch.float32) * keep


def _places(pos, s: int, e: int, device) -> torch.Tensor:
    """The places in the row listing of the listed entries ``[s, e)``."""
    if pos is None:
        return torch.arange(s, e, device=device)
    return pos[s:e].long()


def edge_layout(c_head: int, aligned: bool) -> int:
    """The layout of the per-edge modes, which take only the per-head
    lanes: float4 where a head is whole float4s and the operands are
    16-byte aligned."""
    return PER_HEAD_FLOAT4 if aligned and c_head % 4 == 0 else PER_HEAD_SCALAR


def _node_mode(mask, z: torch.Tensor, *tensors: torch.Tensor) -> Tuple[int, int]:
    """The mode and layout of GAT's weighted sum or backward pass: without a
    mask ``NODE_SCORES`` in :func:`_layout`'s layout, with one ``NODE_MASKED``
    on the per-head lanes."""
    if mask is None:
        return NODE_SCORES, _layout(z, *tensors)
    return NODE_MASKED, edge_layout(z.shape[2], bool(_aligned(z, *tensors)))


def aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz: int, slope: float, mask=None,
                    keep: float = 1.0) -> torch.Tensor:
    """``out[i, h, :] = sum of alpha[e, h] * z[col_e, h, :]`` over the first
    ``nnz`` entries: ``[N, H, C]``; with a ``mask`` (``[H, nnz]``, True where
    a weight is kept) alpha times ``keep`` or 0."""
    out = torch.zeros_like(z)
    step = _step(z)
    for s in range(0, nnz, step):
        r, c = row[s:min(s + step, nnz)].long(), col[s:min(s + step, nnz)].long()
        w = torch.exp(_leaky(s_dst[r] + s_src[c], slope) - m[r]) / l[r]
        if mask is not None:
            w = w * _kept(mask, _places(None, s, s + r.numel(), r.device), keep)
        out.index_add_(0, r, z[c] * w[..., None])
    return out


def aggregate(row, col, s_src, s_dst, m, l, z, nnz: int, slope: float, mask=None,
              keep: float = 1.0) -> torch.Tensor:
    """:func:`aggregate_plain` on its kernel for CUDA tensors (with a mask,
    its per-head instances that read it)."""
    if z.device.type != "cuda":
        return aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz, slope, mask, keep)
    out = torch.zeros_like(z)
    n, h, c = z.shape
    if nnz and c:
        mode, lay = _node_mode(mask, z, out)
        with torch.cuda.device(z.device):
            _launch("gat_aggregate_f32", row.data_ptr(), col.data_ptr(), s_src.data_ptr(),
                    s_dst.data_ptr(), m.data_ptr(), l.data_ptr(), None, _ptr(mask), None, keep,
                    z.data_ptr(), out.data_ptr(), nnz, h, c, slope, mode, lay,
                    _nvcc.stream_of(z))
    return out


def rowdot_plain(g, out, s_dst, m, l) -> torch.Tensor:
    """The row-side values of the backward pass, ``[N, H, 4]``: ``s_dst`` (0
    where it is None: per-edge scores), ``m``, ``l`` and ``delta = <g[i, h,
    :], out[i, h, :]>``."""
    return torch.stack([torch.zeros_like(m) if s_dst is None else s_dst, m, l,
                        (g * out).sum(-1)], dim=-1)


def rowdot(g, out, s_dst, m, l) -> torch.Tensor:
    """:func:`rowdot_plain` on its kernel for CUDA tensors."""
    if g.device.type != "cuda":
        return rowdot_plain(g, out, s_dst, m, l)
    n, h, c = g.shape
    q = torch.empty((n, h, 4), dtype=torch.float32, device=g.device)
    if n:
        with torch.cuda.device(g.device):
            _launch("gat_rowdot_f32", g.data_ptr(), out.data_ptr(), _ptr(s_dst),
                    m.data_ptr(), l.data_ptr(), q.data_ptr(), n, h, c, _nvcc.stream_of(g))
    return q


def backward_plain(t_row, t_col, q, s_src, z, g, nnz: int, slope: float, mask=None, pos=None,
                   keep: float = 1.0):
    """One pass over the transposed listing (source ``t_row``, destination
    ``t_col``): ``dz[j] = sum of alpha * g[i]``, ``ds_src[j]`` and
    ``ds_dst[i]`` the sums of ``dpre = alpha * (<g[i], z[j]> - delta[i]) *
    leaky_relu'(pre)`` over the entries, each head on its own. With a
    ``mask`` (by the row listing's places; ``pos`` the place of each
    transposed entry) alpha in dz and ``<g[i], z[j]>`` in dpre take the
    mask's factor."""
    dz = torch.zeros_like(z)
    ds_src = torch.zeros_like(s_src)
    ds_dst = torch.zeros_like(s_src)
    step = _step(z)
    for s in range(0, nnz, step):
        j, i = t_row[s:min(s + step, nnz)].long(), t_col[s:min(s + step, nnz)].long()
        sd, mi, li, delta = q[i].unbind(-1)
        pre = sd + s_src[j]
        w = torch.exp(_leaky(pre, slope) - mi) / li
        kk = 1.0 if mask is None else _kept(mask, _places(pos, s, s + j.numel(), j.device), keep)
        gi = g[i]
        dz.index_add_(0, j, gi * (w * kk)[..., None])
        dpre = w * (kk * (gi * z[j]).sum(-1) - delta) * torch.where(pre > 0, 1.0, slope)
        ds_src.index_add_(0, j, dpre)
        ds_dst.index_add_(0, i, dpre)
    return dz, ds_src, ds_dst


def backward(t_row, t_col, q, s_src, z, g, nnz: int, slope: float, mask=None, pos=None,
             keep: float = 1.0):
    """:func:`backward_plain` on its kernel for CUDA tensors:
    ``(dz, ds_src, ds_dst)``."""
    if z.device.type != "cuda":
        return backward_plain(t_row, t_col, q, s_src, z, g, nnz, slope, mask, pos, keep)
    n, h, c = z.shape
    dz = torch.zeros_like(z)
    ds_src = torch.zeros_like(s_src)
    ds_dst = torch.zeros_like(s_src)
    if nnz and c:
        mode, lay = _node_mode(mask, z, g, dz)
        with torch.cuda.device(z.device):
            _launch("gat_backward_f32", t_row.data_ptr(), t_col.data_ptr(), s_src.data_ptr(),
                    q.data_ptr(), None, _ptr(mask), _ptr(pos), keep, z.data_ptr(),
                    g.data_ptr(), dz.data_ptr(), ds_src.data_ptr(), ds_dst.data_ptr(), None,
                    1.0, nnz, h, c, slope, mode, lay, _nvcc.stream_of(z))
    return dz, ds_src, ds_dst


def _masked(mask, keep: float) -> dict:
    """The keyword arguments that carry a mask to a step (none without one)."""
    return {} if mask is None else {"mask": mask, "keep": keep}


class _GATAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, s_src, s_dst, edges, slope, mask, keep):
        out, m, l = _forward(z, s_src, s_dst, edges, slope, mask, keep)
        ctx.edges, ctx.slope, ctx.keep = edges, slope, keep
        ctx.save_for_backward(z, s_src, s_dst, m, l, out, mask)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        z, s_src, s_dst, m, l, out, mask = ctx.saved_tensors
        e = ctx.edges
        with span("attn.bwd", device=True):
            _counts(e, z)
            before = _launches()
            g = grad_out.contiguous()
            q = rowdot(g, out, s_dst, m, l)
            extra = _masked(mask, ctx.keep)
            if mask is not None:
                extra["pos"] = e.positions()
            dz, ds_src, ds_dst = backward(e.t_row, e.t_col, q, s_src, z, g, e.nnz, ctx.slope,
                                          **extra)
            _count_launches(before)
        return dz, ds_src, ds_dst, None, None, None, None


def _counts(edges, z) -> None:
    count("attn.edges", int(edges.nnz))
    count("attn.heads", int(z.shape[1]))


def _launches() -> Tuple[int, int]:
    return gat_attention.launches, gat_attention.kernel_launches[ROW_PATH]


def _count_launches(before: Tuple[int, int]) -> None:
    """``attn.launches`` and ``attn.row_launches`` since ``before``."""
    now = _launches()
    count("attn.launches", now[0] - before[0])
    count("attn.row_launches", now[1] - before[1])


def _forward(z, s_src, s_dst, edges, slope, mask=None, keep=1.0):
    with span("attn", device=True):
        _counts(edges, z)
        if mask is not None:
            count("attn.masked", int(mask.numel()))
        before = _launches()
        m, l = softmax_stats(edges.row, edges.col, s_src, s_dst, edges.nnz, slope)
        out = aggregate(edges.row, edges.col, s_src, s_dst, m, l, z, edges.nnz, slope,
                        **_masked(mask, keep))
        _count_launches(before)
    return out, m, l


def _check_mask(name: str, mask, heads: int, edges) -> None:
    if mask is None:
        return
    if mask.dtype != torch.bool or tuple(mask.shape) != (heads, edges.nnz):
        raise TypeError(f"{name}: mask must be bool [{heads}, {edges.nnz}] (heads, entries), "
                        f"got {mask.dtype} {tuple(mask.shape)}")
    _nvcc.check_operands(name, mask=mask, row=edges.row)


def _keep(rate: float) -> float:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} outside [0, 1)")
    return 1.0 / (1.0 - rate)


def gat_attention(z: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor, edges,
                  negative_slope: float = 0.2, mask=None, rate: float = 0.0) -> torch.Tensor:
    """The attention-weighted sum ``[N, H, C]`` of ``z`` over ``edges``, with
    gradients to ``z``, ``s_src`` and ``s_dst`` where grad mode wants them.
    ``mask`` (bool ``[H, E]`` by the row listing's entries, drawn at
    ``rate``) drops the weights it does not keep and scales the others by
    ``1 / (1 - rate)``; None drops none. CUDA tensors run the kernels
    (counted in ``gat_attention.launches``: three a forward pass, two a
    backward; by kernel in ``gat_attention.kernel_launches``), CPU tensors
    the plain versions."""
    z, s_src, s_dst = z.contiguous(), s_src.contiguous(), s_dst.contiguous()
    _check(z, s_src, s_dst, edges)
    _check_mask("gat_attention", mask, z.shape[1], edges)
    slope, keep = float(negative_slope), _keep(float(rate))
    if torch.is_grad_enabled() and (z.requires_grad or s_src.requires_grad
                                    or s_dst.requires_grad):
        return _GATAttention.apply(z, s_src, s_dst, edges, slope, mask, keep)
    return _forward(z, s_src, s_dst, edges, slope, mask, keep)[0]


# -- per-edge scores: the graph-transformer attention --------------------------------


def sddmm_plain(row, col, q, k, nnz: int, scale: float) -> torch.Tensor:
    """``s[h, e] = scale * <q[row_e, h, :], k[col_e, h, :]>`` over the first
    ``nnz`` entries, ``[H, nnz]``: :func:`ssrg_torch.ops.sddmm.sddmm` a head
    at a time."""
    r, c = row[:nnz], col[:nnz]
    if not nnz:
        return q.new_zeros((q.shape[1], 0))
    return torch.stack([sddmm(r, c, q[:, h], k[:, h]) for h in range(q.shape[1])]) * scale


def edge_sddmm(row, col, q, k, nnz: int, scale: float) -> torch.Tensor:
    """:func:`sddmm_plain` on its kernel for CUDA tensors."""
    if q.device.type != "cuda":
        return sddmm_plain(row, col, q, k, nnz, scale)
    n, h, c = q.shape
    s = torch.empty((h, nnz), dtype=torch.float32, device=q.device)
    if nnz and c:
        with torch.cuda.device(q.device):
            _launch("edge_sddmm_f32", row.data_ptr(), col.data_ptr(), q.data_ptr(), k.data_ptr(),
                    s.data_ptr(), nnz, h, c, scale, edge_layout(c, _aligned(q, k)),
                    _nvcc.stream_of(q))
    elif nnz:
        s.zero_()
    return s


def edge_stats_plain(row, s, n: int, nnz: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row maxima ``m`` and sums ``l`` (``[n, H]``) of the softmax of the
    per-edge scores ``s`` (``[H, nnz]``); a row without entries keeps
    ``-inf`` and 0."""
    h = s.shape[0]
    m = torch.full((n, h), float("-inf"), dtype=torch.float32, device=s.device)
    l = torch.zeros((n, h), dtype=torch.float32, device=s.device)
    for a in range(0, nnz, CHUNK):
        r, v = row[a:min(a + CHUNK, nnz)].long(), s[:, a:min(a + CHUNK, nnz)].T
        m.scatter_reduce_(0, r[:, None].expand_as(v), v, "amax", include_self=True)
    for a in range(0, nnz, CHUNK):
        r, v = row[a:min(a + CHUNK, nnz)].long(), s[:, a:min(a + CHUNK, nnz)].T
        l.index_add_(0, r, torch.exp(v - m[r]))
    return m, l


def edge_stats(row, s, n: int, nnz: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`edge_stats_plain` on its kernel (two launches) for CUDA
    tensors."""
    if s.device.type != "cuda":
        return edge_stats_plain(row, s, n, nnz)
    h = s.shape[0]
    m = torch.full((n, h), float("-inf"), dtype=torch.float32, device=s.device)
    l = torch.zeros((n, h), dtype=torch.float32, device=s.device)
    if nnz:
        with torch.cuda.device(s.device):
            _launch("gat_stats_f32", row.data_ptr(), None, None, None, s.data_ptr(),
                    m.data_ptr(), l.data_ptr(), nnz, h, 0.0, _nvcc.stream_of(s))
    return m, l


def edge_aggregate_plain(row, col, s, m, l, z, nnz: int, mask=None,
                         keep: float = 1.0) -> torch.Tensor:
    """``out[i, h, :] = sum of alpha~[e, h] * z[col_e, h, :]`` over the first
    ``nnz`` entries, alpha from the per-edge scores ``s`` and the
    statistics, times the mask's factor (:func:`_kept`)."""
    out = torch.zeros_like(z)
    step = _step(z)
    for a in range(0, nnz, step):
        b = min(a + step, nnz)
        r, c = row[a:b].long(), col[a:b].long()
        w = torch.exp(s[:, a:b].T - m[r]) / l[r]
        if mask is not None:
            w = w * _kept(mask, _places(None, a, b, r.device), keep)
        out.index_add_(0, r, z[c] * w[..., None])
    return out


def edge_aggregate(row, col, s, m, l, z, nnz: int, mask=None, keep: float = 1.0) -> torch.Tensor:
    """:func:`edge_aggregate_plain` on its kernel for CUDA tensors."""
    if z.device.type != "cuda":
        return edge_aggregate_plain(row, col, s, m, l, z, nnz, mask, keep)
    out = torch.zeros_like(z)
    n, h, c = z.shape
    if nnz and c:
        with torch.cuda.device(z.device):
            _launch("gat_aggregate_f32", row.data_ptr(), col.data_ptr(), None, None,
                    m.data_ptr(), l.data_ptr(), s.data_ptr(), _ptr(mask), None, keep,
                    z.data_ptr(), out.data_ptr(), nnz, h, c, 0.0, EDGE_SCORES,
                    edge_layout(c, _aligned(z, out)), _nvcc.stream_of(z))
    return out


def weighted_sum_plain(row, col, w, z, nnz: int, pos=None) -> torch.Tensor:
    """``out[row_e, h, :] += w[h, x_e] * z[col_e, h, :]`` over the first
    ``nnz`` listed entries, ``x_e`` the entry's place in the row listing
    (``pos``; None: the listing is the row listing)."""
    out = torch.zeros_like(z)
    step = _step(z)
    for a in range(0, nnz, step):
        b = min(a + step, nnz)
        r, c = row[a:b].long(), col[a:b].long()
        out.index_add_(0, r, z[c] * w[:, _places(pos, a, b, r.device)].T[..., None])
    return out


def weighted_sum(row, col, w, z, nnz: int, pos=None) -> torch.Tensor:
    """:func:`weighted_sum_plain` on its kernel for CUDA tensors."""
    if z.device.type != "cuda":
        return weighted_sum_plain(row, col, w, z, nnz, pos)
    out = torch.zeros_like(z)
    n, h, c = z.shape
    if nnz and c:
        with torch.cuda.device(z.device):
            _launch("gat_aggregate_f32", row.data_ptr(), col.data_ptr(), None, None, None,
                    None, w.data_ptr(), None, _ptr(pos), 1.0, z.data_ptr(), out.data_ptr(),
                    nnz, h, c, 0.0, EDGE_WEIGHTS, edge_layout(c, _aligned(z, out)),
                    _nvcc.stream_of(z))
    return out


def edge_backward_plain(t_row, t_col, pos, q4, s, z, g, nnz: int, mask=None, keep: float = 1.0,
                        scale: float = 1.0):
    """One pass over the transposed listing (source ``t_row``, destination
    ``t_col``, ``pos`` each entry's place in the row listing): ``dz[j] =
    sum of alpha~ * g[i]`` and ``ds[h, x] = scale * alpha * (k <g[i], z[j]>
    - delta[i])``, k the mask's factor; ``q4`` the packed row values of
    :func:`rowdot`. Returns ``(dz, ds)``, ``ds`` ``[H, nnz]`` by the row
    listing's places."""
    dz = torch.zeros_like(z)
    ds = torch.zeros_like(s)
    step = _step(z)
    for a in range(0, nnz, step):
        b = min(a + step, nnz)
        j, i = t_row[a:b].long(), t_col[a:b].long()
        x = _places(pos, a, b, j.device)
        _sd, mi, li, delta = q4[i].unbind(-1)
        alpha = torch.exp(s[:, x].T - mi) / li
        kk = _kept(mask, x, keep)
        gi = g[i]
        dz.index_add_(0, j, gi * (alpha * kk)[..., None])
        ds[:, x] = (scale * alpha * (kk * (gi * z[j]).sum(-1) - delta)).T
    return dz, ds


def edge_backward(t_row, t_col, pos, q4, s, z, g, nnz: int, mask=None, keep: float = 1.0,
                  scale: float = 1.0):
    """:func:`edge_backward_plain` on its kernel for CUDA tensors."""
    if z.device.type != "cuda":
        return edge_backward_plain(t_row, t_col, pos, q4, s, z, g, nnz, mask, keep, scale)
    n, h, c = z.shape
    dz = torch.zeros_like(z)
    # every entry's ds is written: pos takes each place of the row listing once
    ds = torch.empty_like(s) if nnz and c else torch.zeros_like(s)
    if nnz and c:
        with torch.cuda.device(z.device):
            _launch("gat_backward_f32", t_row.data_ptr(), t_col.data_ptr(), None, q4.data_ptr(),
                    s.data_ptr(), _ptr(mask), _ptr(pos), keep, z.data_ptr(), g.data_ptr(),
                    dz.data_ptr(), None, None, ds.data_ptr(), scale, nnz, h, c, 0.0,
                    EDGE_SCORES, edge_layout(c, _aligned(z, g, dz)), _nvcc.stream_of(z))
    return dz, ds


def _qk_launches(before: int) -> None:
    count("attn.qk_launches", gat_attention.launches - before)


def _dot_forward(q, k, v, edges, mask, keep: float, scale: float):
    with span("attn", device=True):
        _counts(edges, q)
        if mask is not None:
            count("attn.masked", int(mask.numel()))
        before = _launches()
        with span("attn.qk", device=True):
            qk = gat_attention.launches
            s = edge_sddmm(edges.row, edges.col, q, k, edges.nnz, scale)
            _qk_launches(qk)
        m, l = edge_stats(edges.row, s, q.shape[0], edges.nnz)
        out = edge_aggregate(edges.row, edges.col, s, m, l, v, edges.nnz, mask, keep)
        _count_launches(before)
    return out, s, m, l


class _DotAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, edges, mask, keep, scale):
        out, s, m, l = _dot_forward(q, k, v, edges, mask, keep, scale)
        ctx.edges, ctx.keep, ctx.scale = edges, keep, scale
        ctx.save_for_backward(q, k, v, s, m, l, out, mask)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, s, m, l, out, mask = ctx.saved_tensors
        e = ctx.edges
        with span("attn.bwd", device=True):
            _counts(e, q)
            before = _launches()
            g = grad_out.contiguous()
            q4 = rowdot(g, out, None, m, l)
            pos = e.positions()
            dv, ds = edge_backward(e.t_row, e.t_col, pos, q4, s, v, g, e.nnz, mask, ctx.keep,
                                   ctx.scale)
            del q4
            with span("attn.qk.bwd", device=True):
                qk = gat_attention.launches
                dq = weighted_sum(e.row, e.col, ds, k, e.nnz)
                dk = weighted_sum(e.t_row, e.t_col, ds, q, e.nnz, pos)
                _qk_launches(qk)
            _count_launches(before)
        return dq, dk, dv, None, None, None, None


def _check_dot(q, k, v, edges) -> None:
    if q.dim() != 3:
        raise TypeError(f"dot_attention: q must be [N, H, C], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != tuple(q.shape):
            raise TypeError(f"dot_attention: {name} must be {tuple(q.shape)}, got "
                            f"{tuple(t.shape)}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("dot_attention: q, k and v must be float32")
    if edges.t_row is None or edges.nnz is None:
        raise TypeError("dot_attention: edges must carry the transposed listing "
                        "(EdgeList.attention)")
    if edges.num_nodes != q.shape[0]:
        raise TypeError(f"dot_attention: edges of {edges.num_nodes} nodes, q of {q.shape[0]}")
    for name in ("row", "col", "t_row", "t_col"):
        if getattr(edges, name).dtype != torch.int32:
            raise TypeError(f"dot_attention: edges.{name} must be int32")
    if q.device.type == "cuda" and q.shape[2] > MAX_HEAD_WIDTH:
        raise TypeError(f"dot_attention: a head of {q.shape[2]} features; the kernels take at "
                        f"most {MAX_HEAD_WIDTH}")
    _nvcc.check_operands("dot_attention", q=q, k=k, v=v, row=edges.row, col=edges.col,
                         t_row=edges.t_row, t_col=edges.t_col)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, edges, mask=None,
                  rate: float = 0.0) -> torch.Tensor:
    """The graph-transformer attention ``[N, H, C]`` over ``edges`` (an
    attention listing, with or without self-loops): per-edge scores
    ``<q[i, h], k[j, h]> / sqrt(C)``,
    their softmax over each row's entries, the weights the ``mask`` (bool
    ``[H, E]`` by the row listing's entries, drawn at ``rate``) keeps scaled
    by ``1 / (1 - rate)`` and the others dropped, and the weighted sum of
    ``v``; a row without entries gives 0. Gradients to q, k and v where grad
    mode wants them. CUDA tensors run the kernels (four launches a forward
    pass: ``sddmm_kernel``, ``gat_stats_kernel`` twice, ``gat_aggregate_kernel``;
    four a backward: ``gat_rowdot_kernel``, ``gat_backward_kernel``, and
    ``gat_aggregate_kernel`` for dq and for dk), CPU tensors the plain
    versions. The spans ``attn`` and ``attn.bwd`` hold ``attn.qk`` and
    ``attn.qk.bwd``, the scores and their gradient (dq, dk), which count
    ``attn.qk_launches``."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_dot(q, k, v, edges)
    _check_mask("dot_attention", mask, q.shape[1], edges)
    keep, scale = _keep(float(rate)), 1.0 / math.sqrt(q.shape[2])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _DotAttention.apply(q, k, v, edges, mask, keep, scale)
    return _dot_forward(q, k, v, edges, mask, keep, scale)[0]


# -- the scores ------------------------------------------------------------------


def scores_plain(z, a_src, a_dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scores ``(z * a_src).sum(-1)`` and ``(z * a_dst).sum(-1)``,
    ``[N, H]`` each, for ``z = [N, H, C]`` and ``a = [1, H, C]``."""
    return (z * a_src).sum(-1), (z * a_dst).sum(-1)


def _score_part_rows(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * SCORE_MAX_BLOCKS_PER_SM


def scores(z, a_src, a_dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scores_plain` on its kernel for CUDA tensors (one launch)."""
    if z.device.type != "cuda":
        return scores_plain(z, a_src, a_dst)
    n, h, c = z.shape
    s_src = torch.empty((n, h), dtype=torch.float32, device=z.device)
    s_dst = torch.empty_like(s_src)
    if not (n and c):
        return s_src.zero_(), s_dst.zero_()
    with torch.cuda.device(z.device):
        _launch("gat_scores_f32", z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                s_src.data_ptr(), s_dst.data_ptr(), n, h, c, _aligned(z), _nvcc.stream_of(z))
    return s_src, s_dst


def score_grad_plain(z, a_src, a_dst, ds_src, ds_dst):
    """The scores' gradients ``(dz, da_src, da_dst)`` given ``ds_src`` and
    ``ds_dst``: ``dz = ds_src a_src + ds_dst a_dst`` (``[N, H, C]``) and
    ``da = sum over the rows of ds z`` (``a``'s shape)."""
    dz = ds_src[..., None] * a_src + ds_dst[..., None] * a_dst
    return (dz, (ds_src[..., None] * z).sum(0, keepdim=True),
            (ds_dst[..., None] * z).sum(0, keepdim=True))


def score_grad(z, a_src, a_dst, ds_src, ds_dst):
    """:func:`score_grad_plain` on its kernels for CUDA tensors (two
    launches: the gradient, then the sum of the blocks' partial rows of
    ``da``, in a fixed order)."""
    if z.device.type != "cuda":
        return score_grad_plain(z, a_src, a_dst, ds_src, ds_dst)
    n, h, c = z.shape
    if not (n and c):
        return torch.zeros_like(z), torch.zeros_like(a_src), torch.zeros_like(a_dst)
    dz = torch.empty_like(z)
    da_src, da_dst = torch.empty_like(a_src), torch.empty_like(a_dst)
    rows = _score_part_rows(z.device)
    part = torch.empty((rows, 2, h * c), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        _launch("gat_score_grad_f32", z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                ds_src.data_ptr(), ds_dst.data_ptr(), dz.data_ptr(), part.data_ptr(), rows,
                da_src.data_ptr(), da_dst.data_ptr(), n, h, c, _aligned(z, dz),
                _nvcc.stream_of(z))
    return dz, da_src, da_dst


def _scores_forward(z, a_src, a_dst):
    with span("attn.scores", device=True):
        launches = gat_scores.launches
        out = scores(z, a_src, a_dst)
        count("attn.score_launches", gat_scores.launches - launches)
    return out


class _GATScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, a_src, a_dst):
        ctx.save_for_backward(z, a_src, a_dst)
        return _scores_forward(z, a_src, a_dst)

    @staticmethod
    @once_differentiable
    def backward(ctx, ds_src, ds_dst):
        z, a_src, a_dst = ctx.saved_tensors
        with span("attn.scores.bwd", device=True):
            launches = gat_scores.launches
            grads = score_grad(z, a_src, a_dst, ds_src.contiguous(), ds_dst.contiguous())
            count("attn.score_launches", gat_scores.launches - launches)
        return grads


def _check_scores(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor) -> None:
    if z.dim() != 3:
        raise TypeError(f"gat_scores: z must be [N, H, C], got {tuple(z.shape)}")
    n, h, c = z.shape
    for name, a in (("a_src", a_src), ("a_dst", a_dst)):
        if tuple(a.shape) != (1, h, c):
            raise TypeError(f"gat_scores: {name} must be [1, {h}, {c}], got {tuple(a.shape)}")
    if z.dtype != torch.float32 or a_src.dtype != torch.float32 or a_dst.dtype != torch.float32:
        raise TypeError("gat_scores: z, a_src and a_dst must be float32")
    if c > MAX_HEAD_WIDTH:
        raise TypeError(f"gat_scores: a head of {c} features; the kernels take at most "
                        f"{MAX_HEAD_WIDTH}")
    _nvcc.check_operands("gat_scores", z=z, a_src=a_src, a_dst=a_dst)


def gat_scores(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention scores ``s_src, s_dst = [N, H]`` of ``z = [N, H, C]``
    and the weights ``a_src, a_dst = [1, H, C]``, with gradients to all
    three where grad mode wants them. CUDA tensors run the kernels (counted
    in ``gat_scores.launches``: one a forward pass, two a backward), CPU
    tensors ``(z * a).sum(-1)`` under PyTorch's autograd."""
    if z.device.type == "cuda":
        z, a_src, a_dst = z.contiguous(), a_src.contiguous(), a_dst.contiguous()
        _check_scores(z, a_src, a_dst)
        if torch.is_grad_enabled() and (z.requires_grad or a_src.requires_grad
                                        or a_dst.requires_grad):
            return _GATScores.apply(z, a_src, a_dst)
    return _scores_forward(z, a_src, a_dst)


gat_attention.launches = 0
gat_attention.kernel_launches = dict.fromkeys([*(k for ks in KERNELS.values() for k in ks),
                                               ROW_PATH], 0)
gat_scores.launches = 0
