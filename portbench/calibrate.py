"""Readings for the limits of `correct`: for each seed, a cell's run with a
short window and its check (the sound readings), and the control (the
plain reference a precision below, in the program's place) on the same
inputs. Never part of a benchmark run.

    python3 -m portbench.calibrate --workload vio.seq --seconds 2 \
        --seeds 11 12 13 [--control 3]

prints one JSON line a seed: {"seed", "sound": {name: value}, "control":
{name: value}} (the control on the first `--control` seeds)."""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    bench = harness.load_bench()
    cell, config, traffic = harness.load_cell(bench, args.workload)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    for i, seed in enumerate(args.seeds):
        t0 = time.time()
        run = harness.Run(bench, cell, config, traffic, seed, args.seconds,
                          False, torch.device("cuda", 0))
        res = harness.execute(run, entry, t0)
        line = {"seed": seed, "correct": res["correct"],
                "sound": {k: v["value"] for k, v in res["compared"].items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        if i < args.control:
            t1 = time.time()
            line["control"] = entry.control(run)
            line["control_s"] = time.time() - t1
        line["s"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
