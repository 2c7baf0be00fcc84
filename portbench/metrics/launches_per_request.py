"""Kernel launches in the profiled requests, over the requests."""


def read(view, info):
    if not view.calls or not view.kernels:
        return None
    return len(view.kernels) / view.calls
