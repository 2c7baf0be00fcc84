"""The share of the profiled calls' host span in which the device ran
nothing: 1 minus the union of its kernel, copy and fill intervals."""


def read(view, info):
    if view.window_s <= 0 or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
