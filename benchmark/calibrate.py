"""Readings for a cell's limits: the program on many seeds, or the control
(the reference one precision below, in the program's place), each after one
set-up in one process.

    python3 benchmark/calibrate.py --workload config4.bulk --seeds 12 \\
        --seconds 3 [--control] [--first-seed N] [--out FILE]

Prints one line per seed (its result object, ``compared`` holding each
number beside the current limit) and last a summary: each number's largest
and smallest reading over the seeds, and the process's start on the wall
clock (a seed's window starts ``setup_s`` after it).  A cell on several
cards runs on as many ranks, launched as ``run.py`` launches them.  The
benchmark's own runs never run this.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import cells, ranks, runner  # noqa: E402

# seeds far apart and above 32 signed bits, as the checks draw them
STRIDE = 2_654_435_761


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    seeds = [args.first_seed + i * STRIDE for i in range(args.seeds)]
    job = {"workload": args.workload, "seeds": seeds,
           "seconds": args.seconds, "trace": False, "t_start": T_START,
           "device": "cuda", "overrides": {}, "inject": None,
           "control": args.control}
    chips = cells.workload(cells.spec(), args.workload)["chips"]
    if chips == 1:
        res = runner.run_job(job)
    else:
        res = ranks.launch(job, chips, limit_s=120.0 + len(seeds) * (
            args.seconds + 40.0))
    lines = []
    for seed, r in zip(seeds, res):
        lines.append({"seed": seed, "correct": r["correct"],
                      "compared": r["compared"], "metrics": r["metrics"]})
        print(json.dumps(lines[-1]), flush=True)
    worst = {k: max(ln["compared"][k]["value"] for ln in lines)
             for k in lines[0]["compared"]}
    least = {k: min(ln["compared"][k]["value"] for ln in lines)
             for k in lines[0]["compared"]}
    summary = {"workload": args.workload, "control": args.control,
               "seeds": len(seeds), "largest": worst, "smallest": least,
               "t_start": T_START}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
