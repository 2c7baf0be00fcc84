"""The share of the hybrid SpMMs' real entries that the COO tail carries,
from the program's counters ``spmm.tail_nnz`` and ``spmm.ell_nnz`` (counted
from the pack at each SpMM) summed over the capture."""

from portbench import spans


def read(view, info):
    ell = tail = 0
    for r in spans.capture_records(view):
        ell += r["counts"].get("spmm.ell_nnz", 0)
        tail += r["counts"].get("spmm.tail_nnz", 0)
    if ell + tail == 0:
        return None
    return 100.0 * tail / (ell + tail)
