"""Device idle time a head epoch, while the main thread's innermost program
span was ``epoch.evaluate`` or ``eval.forward``; see ``idle_in_step_ms``."""

from portbench import manifest


def read(view, info):
    return manifest.reader("idle_in_step_ms").read(view, info, kind="eval")
