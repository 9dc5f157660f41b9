"""Structured logging + metrics (port of visma_tpu/utils/logging.py, stdlib
only: glog/CHECK -> python logging; metric JSON artifacts; frames/s and
scaling-efficiency counters)."""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

_LOGGER = None


def get_logger(name: str = "visma_tpu_torch") -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s] %(message)s",
                datefmt="%H:%M:%S"))
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER


def check(cond: bool, msg: str = "") -> None:
    """CHECK-style hard assertion (reference glog CHECK macros)."""
    if not cond:
        get_logger().error(f"CHECK failed: {msg}")
        raise AssertionError(msg)


class MetricsWriter:
    """Append-only JSONL metrics stream + summary JSON artifacts."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fp = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, **kv: Any) -> None:
        rec = {"t": round(time.time() - self._t0, 3), **kv}
        line = json.dumps(rec)
        if self._fp:
            self._fp.write(line + "\n")
            self._fp.flush()
        get_logger().info(line)

    def throughput(self, frames: int, seconds: float, chips: int = 1) -> Dict:
        fps = frames / seconds
        rec = {"frames_per_sec": round(fps, 2),
               "frames_per_sec_per_chip": round(fps / chips, 2),
               "chips": chips}
        self.log(**rec)
        return rec

    def scaling_efficiency(self, t_base: float, t_scaled: float,
                           n_base: int, n_scaled: int,
                           work_ratio: float = None) -> float:
        """Weak-scaling efficiency: (work_scaled/work_base) /
        ((t_scaled/t_base) * (n_scaled/n_base))."""
        work_ratio = work_ratio if work_ratio is not None else \
            n_scaled / n_base
        eff = work_ratio * t_base / (t_scaled * (n_scaled / n_base))
        self.log(weak_scaling_efficiency=round(eff, 4),
                 n_base=n_base, n_scaled=n_scaled)
        return eff
