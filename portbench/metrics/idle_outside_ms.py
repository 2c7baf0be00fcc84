"""Device idle time a head epoch, while the main thread was in none of the
epoch's program spans (the caller's loop: the accuracies brought to the
host, the next call); see ``idle_in_step_ms``."""

from portbench import manifest


def read(view, info):
    return manifest.reader("idle_in_step_ms").read(view, info, kind=None)
