"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (quinoa_tpu_torch) on a
machine with the card(s) the cell asks for.  The last line of standard
output is the run's JSON result; the numbers compared with the plain
reference are the last lines of standard error, each beside its limit.
Exits non-zero and prints no result without a card, without the port, or
with JAX or the JAX package loaded once the window has closed.  Every
build and kernel cache stays inside the checkout.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [HERE, ROOT]
    if not os.path.isdir(os.path.join(ROOT, "quinoa_tpu_torch")):
        print("portbench: the port (quinoa_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    from benchlib.harness import ForbiddenModule, NoCard, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          trace=bool(args.trace))
    except (NoCard, ForbiddenModule) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
