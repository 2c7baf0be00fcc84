"""The share of its roofline that ``gat_backward_kernel`` reaches in the
profiled epochs (the backward pass over the transposed listing (dz, dalpha
and the scores' gradients), one launch a backward pass): its least time from
its entries, heads, widths and compulsory bytes
(``portbench/programs/gat.py::kernel_least_s``) over its summed device time;
read only when the profile holds exactly the epochs' expected launches of
it."""

KERNEL = "gat_backward_kernel"


def read(view, info):
    prog = info.get("program")
    if not hasattr(prog, "roofline"):
        return None
    return prog.roofline(KERNEL, view, info)
