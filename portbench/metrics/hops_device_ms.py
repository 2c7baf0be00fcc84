"""Device time of one ``prepare``'s kernels (the hops: the ELL kernel, the
COO tail and the copies between hops), summed, averaged over the profiled
calls."""


def read(view, info):
    if not view.calls or not view.kernels:
        return None
    return 1e3 * sum(k.dur for k in view.kernels) / 1e6 / view.calls
