"""The plain reference's shared parts: the normalized adjacency, products in
a stated precision, dropout masks, Adam, and the comparison numbers.

Plain PyTorch; nothing of the port is imported here or in the model files
beside it, and nothing the port made is read: the adjacency is built again
from the benchmark's edge list, the weights are the benchmark's.

``Precision("float32")`` is the configurations' precision (float32 with
TF32 off). ``Precision("tf32")`` is the control: every operand of a matrix
product, dense or sparse, rounded to TF32 (10 explicit mantissa bits, to
nearest even) before a float32 product, which is what TF32 tensor cores
compute; rounding the operands explicitly makes the control the same on
every device, the CPU included.
"""

from __future__ import annotations

import statistics
import warnings
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

# torch calls its CSR tensors beta and warns at each one built
warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|invariant checks)")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: the low 13 mantissa bits cleared,
    rounding to nearest, ties to even (finite values)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.round = round_tf32 if name == "tf32" else (lambda t: t)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded, its gradient passed through unrounded."""
        return x if self.name == "float32" else x + (self.round(x) - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _MM.apply(a, b, self)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w.t()) + b

    def spmm(self, a: torch.Tensor, at: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``a @ x`` for a sparse CSR ``a``; the gradient is ``at @ g``."""
        return _SpMM.apply(x, a, at, self)

    def sparse(self, a: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return a
        return torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(),
                                       round_tf32(a.values()), a.shape)


class _MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return prec.round(a) @ prec.round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.prec.round
        ga = r(g) @ r(b).t() if ctx.needs_input_grad[0] else None
        gb = r(a).t() @ r(g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, at, prec):
        ctx.at, ctx.prec = at, prec
        return torch.sparse.mm(prec.sparse(a), prec.round(x))

    @staticmethod
    def backward(ctx, g):
        prec = ctx.prec
        return torch.sparse.mm(prec.sparse(ctx.at), prec.round(g.contiguous())), None, None, None


def sym_norm(num_nodes: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``D^-1/2 (A + I) D^-1/2`` of the undirected graph whose edges are
    ``(lo, hi)`` (each once, unit weight) as a float32 sparse CSR; degrees
    count the self-loop, weights are computed in float64 and rounded once."""
    n = num_nodes
    dev = lo.device
    loops = torch.arange(n, device=dev)
    rows = torch.cat([lo, hi, loops])
    cols = torch.cat([hi, lo, loops])
    deg = torch.bincount(rows, minlength=n).double()
    inv = deg.rsqrt()
    vals = (inv[rows] * inv[cols]).float()
    order = torch.argsort(rows * n + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols, vals, (n, n))


def transpose(a: torch.Tensor) -> torch.Tensor:
    """The CSR of ``a``'s transpose, built by sorting its entries again."""
    n, m = a.shape
    crow, cols, vals = a.crow_indices(), a.col_indices(), a.values()
    rows = torch.repeat_interleave(torch.arange(n, device=cols.device), crow.diff())
    order = torch.argsort(cols * n + rows)
    t_crow = torch.zeros(m + 1, dtype=torch.int64, device=cols.device)
    t_crow[1:] = torch.cumsum(torch.bincount(cols, minlength=m), 0)
    return torch.sparse_csr_tensor(t_crow, rows[order], vals[order], (m, n))


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Dropout with the mask ``rand < 1 - rate`` drawn from ``gen`` in the
    shape of ``x`` (one draw a call, in forward order), kept values scaled
    by ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


class Adam:
    """``torch.optim.Adam``'s update written out: L2 weight decay added to
    the gradient, bias-corrected moments, ``eps`` outside the root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, frozen: bool = False) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the update took them.
        ``frozen`` keeps the moments and leaves the parameters unchanged."""
        self.t += 1
        b1, b2 = self.betas
        seen = {}
        for k, p in self.params.items():
            g = p.grad + self.wd * p
            seen[k] = g.clone()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
            if not frozen:
                p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
            p.grad = None
        return seen


FAULTS = ("half_batch", "unchanged")


def faulty(fault: Optional[str], rows: torch.Tensor) -> torch.Tensor:
    """The rows a training loss is taken over: all of them, or under the
    ``half_batch`` fault the first half. ``unchanged`` (an update that
    leaves the parameters where they were) is :meth:`Adam.step`'s
    ``frozen``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    return rows[: rows.numel() // 2] if fault == "half_batch" else rows


def leaf_params(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    names = list(reference) if names is None else names
    median = statistics.median(reference[k] for k in reference)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in names}


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grad_norms.values())
    return [k for k, g in grad_norms.items() if g >= share * median]


def relative_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest absolute difference over the largest reference value."""
    ref = reference.float()
    scale = float(ref.abs().max())
    return float((program.float() - ref).abs().max()) / max(scale, 1e-30)
