"""The readings the limits of `correct` are set from, on the card.

    python3 -m portbench.calibrate --workload NAME --seeds 1,2,3 \
        --seconds 6 [--out chiprun_out/calibrate.jsonl]

For each seed, in one process (the kernels loaded once): a run of the
cell at its own size for a short window, its numbers (init_err, frame_err,
time_err) beside those of the control on the same states: the program's
lower-precision path where it has one (the 2-D float32 kernels for a
float64 cell), else the reference in the precision below the stated one
(bfloat16 for float32).  The benchmark's own runs never run the control.
The last line gives each number's largest program reading (the lower end
of its limit) and smallest control reading (the upper end)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .harness import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run(args.workload, seed, args.seconds, False, control=True)
        row = {"seed": seed, "correct": res["correct"],
               "failed": res["failed"], "attempted": res["attempted"],
               "program": {k: v["value"] for k, v in res["check"].items()},
               "control": res["control"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(row, workload=args.workload)) + "\n")
    names = rows[0]["program"]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "program_max": {n: max(r["program"][n] for r in rows) for n in names},
        "control_min": {n: min(r["control"][n] for r in rows) for n in names},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
