"""The benchmark's run: one cell, one seed, one process.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in BENCHMARK.json:

* `configs[].file`: the configuration (JSON), under portbench/configs/;
* `portbench/traffic/<traffic>.json`: the traffic mix, data only. Its
  `entry` names the module in portbench/entries/ that makes the
  inputs from the seed and drives the program's entry point with them;
* `portbench/metrics/<metric>.py`: a reader with `read(run)`, which returns
  the metric's value, or None where the run has nothing to read.

An entry module has `setup(run)`, `window(run, seconds)` (the measured
window), `trace_unit(run)` (the fixed work of a traced window),
`release(run)` (frees the program's state) and `check(run)` (the
comparisons that decide `correct`, as (name, value, limit)).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import trace_read

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "visma_tpu")
THREADS = 2                    # host threads: load from one steady process


class Run:
    """What one run knows: its cell, inputs, measurements and readings."""

    def __init__(self, bench, cell, config, traffic, seed, seconds, trace,
                 device):
        self.bench, self.cell = bench, cell
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.frames = 0
        self.window_s = None
        self.latencies_ms = []
        self.attempted = 0
        self.failed = 0
        self.window = None              # trace_read.Window of a traced run
        self.trace_frames = None
        self.shapes = {}
        self.notes = {}
        self.power_limit_w = None
        self.span = trace_read.Spans()      # `with run.span(name):`
        self.t_start = time.time()
        self._last = self.t_start

    def note(self, phase: str) -> None:
        """Record the seconds since the last note (or the start) as the
        set-up phase `phase`; the cuda queue is drained first."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.notes.setdefault("setup_phases_s", {})[phase] = now - self._last
        self._last = now


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fp:
        return json.load(fp)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"BENCHMARK.json names no {what} {name!r}")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") a cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_metric(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, workload: str, root: Path = ROOT):
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "configuration")
    with open(root / conf["file"]) as fp:
        config = json.load(fp)
    with open(PKG / "traffic" / f"{cell['traffic']}.json") as fp:
        traffic = json.load(fp)
    return cell, config, traffic


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not run:
    JAX, Flax and the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def measure(run: Run, entry) -> None:
    """Set-up is done: the window, or the traced window, then the readers."""
    if run.trace:
        run.window = trace_read.traced(entry.trace_unit(run), run.span)
        run.window_s = run.window.window_s
    else:
        entry.window(run, run.seconds)


def read_metrics(run: Run) -> dict:
    kind = "per_layer" if run.trace else "end_to_end"
    out = {}
    for entry in metrics_of(run.bench, run.cell["name"], kind):
        value = load_metric(entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def execute(run: Run, entry, t_start: float) -> dict:
    """Set-up, window, metrics, release, check: the result's line."""
    run.t_start = run._last = t_start
    run.note("start_s")           # the interpreter, torch, the card's context
    entry.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.setup_s = time.time() - t_start
    measure(run, entry)
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    if run.device.type == "cuda":
        run.power_limit_w = power_limit_w()
    metrics = read_metrics(run)
    entry.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    compared = entry.check(run)
    ok = all(v <= lim for _, v, lim in compared) and run.failed == 0
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics,
              "device": device}
    if run.trace:
        w = run.window
        run.notes["trace"] = {
            "untraced_unit_s": w.plain_s, "traced_unit_s": w.window_s,
            "device_span_s": w.span_s(),
            "profiler_overhead": w.window_s / w.plain_s - 1.0}
        device["busy_s"] = run.window.busy_s()
        device["window_s"] = run.window.window_s
        result["breakdown"] = {"device_ops": run.window.device_ops(10),
                               "idle_gaps": run.window.idle_gaps(10)}
    run.notes["power_limit_w"] = run.power_limit_w
    result["notes"] = run.notes
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    bench = load_bench()
    cell, config, traffic = load_cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    run = Run(bench, cell, config, traffic, args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0))
    result = execute(run, entry, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}, which the "
              "benchmark may not run", file=sys.stderr)
        return 3
    return report(result)


def report(result: dict) -> int:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output."""
    for name, c in result["compared"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def rehearse(workload: str, seed: int, seconds: float, config=None,
             traffic=None, device: str = "cpu") -> dict:
    """A run without the look for a chip, at sizes changed by `config` and
    `traffic` (nested dicts merged over the files'), for the tests and for
    a rehearsal on the CPU. Returns the result's dict. Never a
    measurement."""
    bench = load_bench()
    cell, conf, traf = load_cell(bench, workload)
    conf, traf = _merge(conf, config), _merge(traf, traffic)
    entry = importlib.import_module(f"portbench.entries.{traf['entry']}")
    run = Run(bench, cell, conf, traf, seed, seconds, False,
              torch.device(device))
    return execute(run, entry, time.time())
