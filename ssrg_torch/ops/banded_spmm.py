"""Banded SpMM: the hand-written CUDA kernel, its plain PyTorch version and
its launch count.

``banded_spmm(blocks, los, x, round_x)`` computes, for every row block
``b``, ``out[b*rb:(b+1)*rb] = blocks[b] @ xt[los[b] : los[b] + W]`` with f32
accumulation, where ``xt`` is ``x`` rounded to bf16 when ``round_x`` is set
or the blocks are bf16, and window rows at or past ``N`` read as zero. It is
the port of ``ssrg_tpu/ops/pallas_banded.py::_banded_kernel`` and carries
``PallasBandedAdj.spmm``, the engine ``spmm_engine="reorder_banded"`` runs
on the card.

For CUDA tensors the wrapper launches ``csrc/banded_spmm.cu``, which
:mod:`ssrg_torch.ops._nvcc` builds at first use, on the path :func:`path`
picks by the blocks' type: bf16 blocks go to the tensor cores (a dense
bf16 x bf16 -> f32 product, as the reference's MXU dot), f32 blocks to the
stream kernel that skips zero entries. For CPU tensors it runs
:func:`banded_spmm_plain`, which ``BandedAdj.spmm`` (the counterpart of the
reference's XLA banded engine) also runs on any device.
"""

from __future__ import annotations

import ctypes

import torch

from ssrg_torch.ops import _nvcc

NAME = "banded_spmm"
# the C entry's path argument is the index in this tuple
PATHS = ("stream", "tensor_core")

# bytes of f32 temporaries (the block group, its windows and its products)
# the plain version holds at once
_PLAIN_GROUP_BYTES = 1 << 28


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.banded_spmm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def _check(blocks: torch.Tensor, los: torch.Tensor, x: torch.Tensor) -> None:
    if blocks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"banded_spmm: blocks must be float32 or bfloat16, got {blocks.dtype}")
    if los.dtype != torch.int32:
        raise TypeError(f"banded_spmm: los must be int32, got {los.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"banded_spmm: x must be float32, got {x.dtype}")
    if blocks.dim() != 3 or los.shape != blocks.shape[:1]:
        raise TypeError(
            f"banded_spmm: blocks must be [nb, rb, W] and los [nb], got "
            f"{tuple(blocks.shape)} and {tuple(los.shape)}"
        )
    if x.dim() != 2:
        raise TypeError(f"banded_spmm: x must be [N, F], got {tuple(x.shape)}")
    _nvcc.check_operands("banded_spmm", blocks=blocks, los=los, x=x)
    if max(blocks.shape) >= 2**31 or x.shape[1] >= 2**31:
        raise TypeError("banded_spmm: nb, rb, W and F must fit in int32")


def path(blocks: torch.Tensor) -> str:
    """The kernel path a product of ``blocks`` takes on the card:
    ``"tensor_core"`` for bf16 blocks, ``"stream"`` for f32 blocks, with
    either window (``round_x``). A tensor core multiplies bf16 x bf16 exactly, as the
    reference's MXU dot does; f32 blocks (with an f32 or a bf16 window) it
    cannot, and their packs are mostly zeros, which the stream kernel skips.
    The rule is by type, not by density; nothing else picks the path."""
    return "tensor_core" if blocks.dtype == torch.bfloat16 else "stream"


def _round_window(x: torch.Tensor, round_x: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if round_x else x


def banded_spmm_plain(blocks: torch.Tensor, los: torch.Tensor, x: torch.Tensor,
                      round_x: bool = False) -> torch.Tensor:
    """The plain PyTorch version: gather each block's window of ``x``
    (zero rows past ``N``) and multiply in f32 with ``torch.bmm``, in groups
    of blocks that bound the temporaries."""
    nb, rb, w = blocks.shape
    f = x.shape[1]
    round_x = round_x or blocks.dtype == torch.bfloat16
    need = int(los.max()) + w if nb else 0
    xp = x
    if need > x.shape[0]:
        xp = torch.cat([x, x.new_zeros((need - x.shape[0], f))])
    out = torch.empty((nb * rb, f), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_GROUP_BYTES // (4 * (rb * w + w * f + rb * f)))
    offs = torch.arange(w, device=x.device)
    for b0 in range(0, nb, step):
        lo = los[b0:b0 + step].long()
        windows = _round_window(xp[lo[:, None] + offs], round_x)   # [g, W, F]
        prod = torch.bmm(blocks[b0:b0 + step].float(), windows)     # [g, rb, F]
        out[b0 * rb:(b0 + lo.shape[0]) * rb] = prod.reshape(-1, f)
    return out


NO_GRAD = ("the banded kernel is forward-only, as the reference's _banded_kernel "
           "(csrc/banded_spmm.cu's note, PERF.md section 6); differentiate through the dense or "
           "hybrid engine")


def banded_spmm(blocks: torch.Tensor, los: torch.Tensor, x: torch.Tensor,
                round_x: bool = False) -> torch.Tensor:
    """``out[b*rb + i] = sum_k blocks[b, i, k] * xt[los[b] + k]``.

    blocks f32 or bf16 ``[nb, rb, W]``, los int32 ``[nb]`` (window starts,
    unclamped: rows at or past ``N`` read as zero), x f32 ``[N, F]``, all
    contiguous on one device; returns f32 ``[nb * rb, F]``. ``xt`` is ``x``
    rounded to bf16 when ``round_x`` is set or the blocks are bf16. The
    window starts must be >= 0, as the pack functions guarantee; the kernel does
    not check them. CUDA tensors go to the kernel on :func:`path`'s path
    (counted in ``banded_spmm.launches``, one a product whatever the path
    launches inside it, and in ``banded_spmm.path_launches`` by path), CPU
    tensors to :func:`banded_spmm_plain`.
    Forward only, as the reference's kernel: asked for a gradient, it
    raises."""
    _check(blocks, los, x)
    _nvcc.refuse_grad(NAME, NO_GRAD, blocks=blocks, x=x)
    if x.device.type == "cpu":
        return banded_spmm_plain(blocks, los, x, round_x)
    nb, rb, w = blocks.shape
    f = x.shape[1]
    out = torch.empty((nb * rb, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if w == 0:
        return out.zero_()
    bf16 = blocks.dtype == torch.bfloat16
    chosen = path(blocks)
    # the tensor-core path's scratch: x rounded to bf16, rows padded to 8 features
    window = (torch.empty((max(x.shape[0], 1), (f + 7) // 8 * 8), dtype=torch.bfloat16,
                          device=x.device) if chosen == "tensor_core" else None)
    lib = _nvcc.library(NAME, _declare)
    with torch.cuda.device(x.device):
        err = lib.banded_spmm(
            blocks.data_ptr(), int(bf16), los.data_ptr(), x.data_ptr(), out.data_ptr(),
            nb, rb, w, x.shape[0], f, int(round_x or bf16), PATHS.index(chosen),
            None if window is None else window.data_ptr(), _nvcc.stream_of(x),
        )
    _nvcc.check_launch(NAME, err)
    banded_spmm.launches += 1
    banded_spmm.path_launches[chosen] += 1
    return out


banded_spmm.launches = 0
banded_spmm.path_launches = dict.fromkeys(PATHS, 0)
