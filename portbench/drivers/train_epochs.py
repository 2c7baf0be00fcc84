"""Full-batch training epochs, back to back: the user's loop step of the
configuration's training entry (``train_epoch`` then ``evaluate``, the
accuracies brought to the host).

Set-up builds the program's task and one train state over the benchmark's
weights and drives it through ``checked_steps`` epochs, through the same
call the window makes; those epochs are also the warm-up. The window then
runs epochs on that same state until ``--seconds`` have passed:
``epoch_ms`` (``head_epoch_ms`` for a head over precomputed hops) is the
window's time over the epochs it completed. With a
trace, ``capture_s`` worth of epochs (at least ``capture_min``) are
profiled afterwards. The reference then follows the first
``checked_steps`` epochs from the same weights and dropout stream:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the median leaf's gap between the norms of the first
  gradient (the program's worked out from Adam's first moment);
- ``step_gap``: the median leaf's gap between the norms of the change
  after the checked steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

from portbench import graphs, manifest, tracing
from portbench.driving import Outcome
from portbench.programs.common import make_weights
from portbench.reference.common import leaf_gaps, moved_leaves


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    prog, ref = ctx.program(), ctx.reference()
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], ctx.seed, ctx.device)
    ctx.mark("data")
    weights = make_weights(prog.weight_shapes(cfg), ctx.seed, ctx.device)
    session = prog.TrainSession(data, cfg, weights, ctx.seed, ctx.device)
    ctx.mark("program")
    steps = int(traffic["checked_steps"])
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(session.step()))
        if i == 0:
            grads = session.first_gradient_norms()
    change = session.change_norms(weights)
    ctx.mark("steps")

    t0 = ctx.open_window()
    epochs = 0
    while True:
        session.step()
        epochs += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    peak = ctx.memory_peak()
    per_epoch = elapsed / epochs

    view, info = None, {}
    if ctx.trace:
        calls = max(int(traffic["capture_min"]), math.ceil(float(traffic["capture_s"]) / per_epoch))
        view = tracing.capture(session.step, calls, ctx.device, ctx.device.type == "cuda")
        info = {"wall_s_per_call": per_epoch, "work": prog.epoch_work(cfg, data),
                "pack": session.pack(), "config": cfg, "data": data, "program": prog}
    session.close()
    del session
    ctx.free()

    expect = ref.train_steps(data, cfg, weights, ctx.seed, steps)
    got = {"losses": losses, "grads": grads, "change": change}
    for what in ("grads", "change"):
        gaps = leaf_gaps(got[what], expect[what])
        print(f"leaf gaps of {what}: " + " ".join(f"{k}={v:.3g}" for k, v in gaps.items()),
              file=sys.stderr)
    # one measure under the names the manifest gives it: ``epoch_ms`` for
    # the SpMM-bound GCN, ``head_epoch_ms`` for a head over the hop stack
    return Outcome({"epoch_ms": 1e3 * per_epoch, "head_epoch_ms": 1e3 * per_epoch,
                    "setup_s": ctx.setup_s}, epochs, 0, peak,
                   ctx.checks(compare(got, expect)), view, info)


def compare(got: dict, expect: dict) -> dict:
    """The numbers compared, from the program's readings (``losses``,
    ``grads``, ``change``) and the reference's. The gradient and the change
    are taken by the median leaf, not the worst: a small leaf's gap swings
    from seed to seed (a scalar's gradient that sums millions of terms that
    cancel; under Adam, elements whose gradient is near zero stepping on
    round-off alone). Every leaf's gap is printed on standard error."""
    moved = moved_leaves(expect["grads"])
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(got["losses"], expect["losses"])),
        "grad_gap": statistics.median(leaf_gaps(got["grads"], expect["grads"]).values()),
        "step_gap": statistics.median(leaf_gaps(got["change"], expect["change"], moved).values()),
    }


def control(cell, cfg: dict, seed: int, device, seconds: float, fault: str = None) -> dict:
    """The numbers compared with the reference computed in TF32 in the
    program's place, or with ``fault`` the float32 reference with that
    fault planted (``portbench/reference/common.py::FAULTS``)."""
    prog, ref = manifest.program(cfg["model"]), manifest.reference(cfg["model"])
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], seed, device)
    weights = make_weights(prog.weight_shapes(cfg), seed, device)
    steps = int(cell.traffic["checked_steps"])
    got = (ref.train_steps(data, cfg, weights, seed, steps, "tf32") if fault is None else
           ref.train_steps(data, cfg, weights, seed, steps, fault=fault))
    return compare(got, ref.train_steps(data, cfg, weights, seed, steps))
