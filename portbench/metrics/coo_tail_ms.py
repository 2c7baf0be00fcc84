"""Device time of the hybrid pack's COO tail in one training epoch
(``ops/sparse.py::COOAdj.accumulate``: a gather, a scaling and an
``index_add_`` a chunk), over the epochs. A hybrid SpMM runs the ELL kernel
and then its tail, so the tail's kernels are the ``3 * chunks`` that follow
each ELL launch on the stream; they are counted only when each of them was
launched by one of the tail's operators, and the reader finds nothing
otherwise."""

TAIL_OPS = ("aten::index_select", "aten::gather", "aten::mul", "aten::index_add_")
ELL_KERNEL = "ell_spmm_kernel"


def read(view, info):
    chunks = (info.get("pack") or {}).get("tail_chunks")
    if not chunks:
        return None
    kernels = sorted(view.kernels, key=lambda k: k.ts)
    starts = [i for i, k in enumerate(kernels) if ELL_KERNEL in k.name]
    total = 0.0
    for i in starts:
        tail = kernels[i + 1:i + 1 + 3 * chunks]
        if len(tail) != 3 * chunks or any(k.op not in TAIL_OPS for k in tail):
            return None
        total += sum(k.dur for k in tail)
    if not starts:
        return None
    return 1e3 * total / 1e6 / view.calls
