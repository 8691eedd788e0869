"""Run one benchmark cell of sz3_tpu_torch once.

    python3 szbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. The cell, its
configuration, traffic mix and per-layer metrics are found by name
(szbench/README.md). The last line of standard output is one JSON object;
the last lines of standard error are the numbers compared with their limits.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    # the script's own folder would shadow top-level names with its subfolders
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if root not in sys.path:
        sys.path.insert(0, root)
    from szbench.harness import cell

    return cell.main(argv, root, T_START)


if __name__ == "__main__":
    sys.exit(main())
