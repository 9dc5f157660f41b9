"""What the script twins share: the card's line, a clock that times the
device, and where a result file goes."""
from __future__ import annotations

import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

ROOT = Path(__file__).resolve().parents[2]
BUILD = ROOT / "build" / "tools"


def card_line(device: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` on a CUDA device, the
    device's name elsewhere."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def elapsed_ms(fn: Callable, device: torch.device) -> float:
    """ms that fn() takes: CUDA events on a CUDA device (the host returns
    when the work is queued; the events time the device), the host clock
    elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def best_ms(fn: Callable, device: torch.device, reps: int) -> float:
    """The least of `reps` timings of fn()."""
    return min(elapsed_ms(fn, device) for _ in range(reps))


def output_path(path: str, default_name: str) -> Path:
    """`--output` as a Path, `build/tools/<default_name>` when empty; its
    directory made."""
    out = Path(path) if path else BUILD / default_name
    out.parent.mkdir(parents=True, exist_ok=True)
    return out
