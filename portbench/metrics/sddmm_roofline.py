"""The share of its roofline that ``sddmm_kernel`` reaches in the profiled
epochs (the per-edge scores ``<q[i], k[j]> / sqrt(C)``, one launch a
forward pass): its least time from its entries, heads, widths and
compulsory bytes (the program's ``kernel_least_s``) over its summed device
time; read only when the profile holds exactly the epochs' expected
launches of it."""

KERNEL = "sddmm_kernel"


def read(view, info):
    prog = info.get("program")
    if not hasattr(prog, "roofline"):
        return None
    return prog.roofline(KERNEL, view, info)
