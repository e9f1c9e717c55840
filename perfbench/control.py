"""Read the two ends of each limit that decides ``correct``, on the card:

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 5]

For each seed, one run of the cell as ``run.py`` makes it (its set-up, a
short window at the cell's own load, the check of a sample of its requests
drawn from the seed) prints the program's numbers (the lower readings), and
the control, the plain reference computed in TF32 put in the program's
place over the same queries, prints its numbers (the upper readings): a
sound limit lies between the two. The benchmark's own runs do not run the
control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(REPO)

from perfbench import cells, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(REPO / "BENCHMARK.json", args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.execute(cell, seed, args.seconds, False, t_start=t0, tf32_control=True)
        program = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "program": program, "control": res["control_checks"],
                          "control_correct": res["control_correct"],
                          "device": res["device"]["kind"],
                          "power_limit_w": res["device"].get("power_limit_w")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
