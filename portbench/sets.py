"""Runs of one cell, each a process of its own as the benchmark's checks
make them, and the spread of each metric over them.

    python3 -m portbench.sets --workload NAME --seeds 11,12,13 \
        --seconds 20 [--trace 1] [--out chiprun_out/sets.jsonl]

Each run's result line (with its seed, exit code and wall seconds) is
appended to `--out`; at the end one line per metric gives its median and
its quartile spread (stats.spread) over the runs, and how many runs were
correct."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .stats import spread


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "portbench", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": p.returncode, "wall_s": wall, "result": result,
            "stderr_tail": p.stderr[-1500:]}


def summary(runs: list) -> dict:
    out = {}
    ok = [r["result"] for r in runs if r["result"] is not None]
    names = sorted({n for r in ok for n in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
        row = {"runs": len(vals), "median": statistics.median(vals),
               "min": min(vals), "max": max(vals)}
        if len(vals) >= 2:
            row["spread"] = spread(vals)
        out[n] = row
    out["correct"] = [bool(r.get("correct")) for r in ok]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = one_run(args.workload, seed, args.seconds, args.trace)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({"seed": seed, "rc": r["rc"], "wall_s": r["wall_s"],
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "check": res.get("check"),
                          "device": res.get("device")}), flush=True)
        if r["result"] is None:
            print(r["stderr_tail"], file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    print(json.dumps({"workload": args.workload, "trace": args.trace,
                      "summary": summary(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
