"""The control of ``correct``: the plain reference computed in TF32 (the
precision below the configurations' float32 with TF32 off) put in the
program's place, at the cell's own size, read by the cell's own numbers.
Each number should come out above its limit for at least one of them.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 10] [--fault F]

Prints one JSON line a seed: the numbers, the limits, and whether the
control was caught (``caught``: some number above its limit). Needs a card;
the CPU tests call :func:`readings` on small copies of the configurations.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402


def readings(workload: str, seed: int, device, seconds: float, config: dict = None,
             fault: str = None, root: str = ROOT) -> dict:
    from portbench import manifest

    cell = manifest.cell(workload, root)
    driver = manifest.driver(cell.traffic["driver"], root)
    return driver.control(cell, config or cell.config, seed, device, seconds, fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--fault", default=None,
                   help="in place of the TF32 reference, the float32 one with this fault "
                        "(training cells: half_batch, unchanged)")
    args = p.parse_args(argv)
    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = args.seconds or float(manifest.load()["run_seconds"])
    limits = manifest.read_json(os.path.join(HERE, "limits", f"{args.workload}.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        values = readings(args.workload, seed, torch.device("cuda", 0), seconds,
                          fault=args.fault)
        caught = any(values[k] > limits[k] for k in limits)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "values": values,
                          "limits": limits, "caught": caught}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
