"""Operations and bytes from shapes: the least time of a piece of work on
one NVIDIA H100 SXM, for the roofline and ``mfu`` metrics.

A piece of work's least time is the larger of its floating-point
operations over the dtype's peak and its compulsory bytes over the
device memory's bandwidth. Compulsory bytes count each input read once and
each output written once, whatever a kernel reads again; sparse work is
counted from the graph (nonzeros, rows, features), never from a pack's
padded slots. Peaks are NVIDIA's data sheet (SXM part, dense, at the full
700 W): the port's ``chip_smoke.py`` bounds use the same three numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
F32 = 4  # bytes of a float32 value or an int32 index


@dataclass
class Work:
    """A sum of pieces of work, each bounded on its own."""

    flops: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0
    parts: List[tuple] = field(default_factory=list)

    def add(self, name: str, flops: float, nbytes: float, dtype: str = "float32") -> "Work":
        t = max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
        self.flops += flops
        self.bytes += nbytes
        self.least_s += t
        self.parts.append((name, flops, nbytes, t))
        return self


def gemm(work: Work, name: str, m: int, k: int, n: int) -> Work:
    """``[m, k] @ [k, n]`` in float32: ``2mkn`` operations, both operands
    read and the product written once."""
    return work.add(name, 2.0 * m * k * n, F32 * (m * k + k * n + m * n))


def spmm(work: Work, name: str, nnz: int, rows: int, cols: int, features: int) -> Work:
    """``A @ x`` with ``nnz`` stored nonzeros: one multiply-add a nonzero
    and feature; the nonzeros' values and column ids, x and the output once
    each."""
    return work.add(name, 2.0 * nnz * features,
                    F32 * (2 * nnz + cols * features + rows * features))


def elementwise(work: Work, name: str, numel: int, tensors: int) -> Work:
    """A pass over ``numel`` values that moves ``tensors`` such tensors
    (inputs read and outputs written); one operation a value."""
    return work.add(name, float(numel), F32 * numel * tensors)


def adam(work: Work, params: int) -> Work:
    """One Adam update of ``params`` float32 parameters: parameter,
    gradient and both moments read, parameter and moments written."""
    return work.add("adam", 12.0 * params, F32 * 7 * params)
