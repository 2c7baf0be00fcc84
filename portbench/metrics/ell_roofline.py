"""The ELL kernel's share of its roofline in a training epoch: the least
time of the edges its launches carry (values and column ids, x read once,
the output written once; padded slots not counted) over the kernels' summed
device time. Read only when the profile holds exactly the epoch's expected
launches."""

KERNEL = "ell_spmm_kernel"


def read(view, info):
    pack, prog = info.get("pack") or {}, info.get("program")
    if "ell_width" not in pack or not hasattr(prog, "ell_least_s"):
        return None
    launches = view.kernels_named(KERNEL)
    expected = view.calls * len(prog.spmm_features(info["config"]))
    busy = sum(k.dur for k in launches) / 1e6
    if len(launches) != expected or busy <= 0:
        return None
    least = view.calls * prog.ell_least_s(info["config"], info["data"], pack["ell_width"])
    return 100.0 * least / busy
