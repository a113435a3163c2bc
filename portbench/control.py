"""The control of a cell and its planted faults, through the harness's own
run and comparison; their numbers have to come out above the cell's
limits.  The control is the plain reference put in the program's place,
computed in the nearest precision below the configuration's (float32 for
float64, bfloat16 for float32); a fault breaks the program's timed path
underneath (a step that returns its state unchanged, half of the
elements left out of each step, one answer altered where it is produced).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5 [--fault half]

prints one JSON line a seed with the compared numbers.  The benchmark's
own runs never run it.
"""

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FAULTS = ("unchanged", "half", "altered")


class Broken:
    """The program's solver with its step broken in one of FAULTS."""

    def __init__(self, solver, how):
        self._s, self.how = solver, how
        self.system = solver.system

    def step(self, st):
        import torch

        if self.how == "unchanged":
            return st
        new = self._s.step(st)
        u = new.u
        if self.how == "half":
            keep = torch.arange(u.shape[1], device=u.device) % 2 == 0
            u = torch.where(keep, u, st.u)
        elif self.how == "altered":
            u = u.clone()
            u[0, u.shape[1] // 2] += 0.1 * u[0].abs().max()
        return dataclasses.replace(new, u=u)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from benchlib import catalog
    from benchlib.check import LOWER
    from benchlib.harness import run_cell

    if args.fault:
        kw, what = {"wrap": lambda s: Broken(s, args.fault)}, args.fault
    else:
        what = LOWER[catalog.cell(args.workload)["config"]["precision"]]
        kw = {"control_dtype": what}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": what, "correct": r["correct"],
                          "steps": r["attempted"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
