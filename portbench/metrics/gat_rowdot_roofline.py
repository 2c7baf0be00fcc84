"""The share of its roofline that ``gat_rowdot_kernel`` reaches in the profiled
epochs (the backward pass's row dot products delta = <g, out>, one launch a
backward pass): its least time from its entries, heads, widths and
compulsory bytes (``portbench/programs/gat.py::kernel_least_s``) over its
summed device time; read only when the profile holds exactly the epochs'
expected launches of it."""

KERNEL = "gat_rowdot_kernel"


def read(view, info):
    prog = info.get("program")
    if not hasattr(prog, "roofline"):
        return None
    return prog.roofline(KERNEL, view, info)
