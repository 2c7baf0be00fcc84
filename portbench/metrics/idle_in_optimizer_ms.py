"""Device idle time a head epoch, while the main thread's innermost program
span was ``step.optimizer`` (Adam's update); see ``idle_in_step_ms``."""

from portbench import manifest


def read(view, info):
    return manifest.reader("idle_in_step_ms").read(view, info, kind="optimizer")
