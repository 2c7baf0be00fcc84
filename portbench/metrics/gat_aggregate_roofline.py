"""The share of its roofline that ``gat_aggregate_kernel`` reaches in the
profiled epochs (the attention's weighted sum of z, one launch a forward
pass): its least time from its entries, heads, widths and compulsory bytes
(``portbench/programs/gat.py::kernel_least_s``) over its summed device time;
read only when the profile holds exactly the epochs' expected launches of
it."""

KERNEL = "gat_aggregate_kernel"


def read(view, info):
    prog = info.get("program")
    if not hasattr(prog, "roofline"):
        return None
    return prog.roofline(KERNEL, view, info)
