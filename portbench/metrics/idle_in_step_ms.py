"""Device idle time a head epoch, while the main thread's innermost program
span was the training step: ``epoch.train``, ``step.forward`` or
``step.backward``. The four ``idle_*`` metrics partition the device's idle
time inside the capture's program spans (``portbench/spans.py``)."""

from portbench import spans

KINDS = {"step": ("epoch.train", "step.forward", "step.backward"),
         "optimizer": ("step.optimizer",),
         "eval": ("epoch.evaluate", "eval.forward")}


def read(view, info, kind="step"):
    split = spans.idle_by_span(view, KINDS)
    if split is None or not view.calls:
        return None
    return split[kind] / 1e3 / view.calls
