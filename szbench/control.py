"""Read the control of a cell: the reference put in the program's place, one
precision below the configuration's (reference/control.py), driven through
the cell's own entry, inputs and check for a short window, on several seeds.
Its max_err_over_eb has to come out above the limit on every seed.

    python3 szbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 5]

Prints one JSON line a seed. The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if root not in sys.path:
        sys.path.insert(0, root)
    from szbench.harness import cell, manifest
    from szbench.reference.control import Control

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    c = manifest.find_cell(manifest.load_manifest(root), args.workload, root)
    failed_all = True
    for seed in args.seeds:
        r = cell.run(c, seed, args.seconds, False, args.device, time.perf_counter(),
                     program=Control(args.device))
        checks = r["checks"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bfloat16",
                          "correct": r["correct"], "checks": checks}), flush=True)
        failed_all &= not r["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
