"""Multi-host orchestration helpers (port of visma_tpu/dist/multihost.py).

Each process calls `initialize()` once before it builds a mesh: it joins
the torch.distributed process group (the reference's jax.distributed
rendezvous). Failure detection / recovery: workers checkpoint every K
steps (visma_tpu_torch.utils.checkpoint) and touch a Heartbeat file; a
Watchdog supervises the worker process, detects death or a stale
heartbeat, and restarts it; the worker resumes from its latest snapshot.
`Heartbeat` and `Watchdog` are pure Python and the reference's source,
unchanged (tests/test_torch_import.py holds them equal). Exercised as a
kill-and-recover drill in tests/test_torch_checkpoint.py.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from visma_tpu_torch.utils.misc import resolve_device


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """torch.distributed.init_process_group with the reference's
    environment defaults (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES,
    PROCESS_ID). No-op without a coordinator (one process).

    device: where this process computes (None: the CUDA card; with several
    cards, process p takes card p modulo their count). The backend is nccl
    for a CUDA device, each process owning its card (NCCL refuses two ranks
    on one card), and gloo for the CPU."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    n = num_processes or int(os.environ["NUM_PROCESSES"])
    rank = process_id if process_id is not None \
        else int(os.environ["PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=n, rank=rank)


class Heartbeat:
    """Minimal liveness file for external monitors: touch() from the train
    loop, stale() from a watchdog."""

    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def touch(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as fp:
                fp.write(f"{step} {now}\n")
            self._last = now

    def stale(self, timeout_s: float = 120.0) -> bool:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            return True
        return (time.time() - mtime) > timeout_s


class Watchdog:
    """Supervise a worker process; restart it from its latest checkpoint on
    death or heartbeat staleness.

    spawn: callable returning a started subprocess.Popen — it must launch
    the worker in RESUME mode (the worker itself loads the latest snapshot
    via visma_tpu_torch.utils.checkpoint.latest_step/load_state, so a restart
    after any failure continues instead of recomputing).
    """

    def __init__(self, spawn: Callable[[], subprocess.Popen],
                 heartbeat_path: str, stale_timeout_s: float = 120.0,
                 poll_s: float = 2.0, max_restarts: int = 3):
        self.spawn = spawn
        self.hb = Heartbeat(heartbeat_path)
        self.stale_timeout_s = stale_timeout_s
        self.poll_s = poll_s
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self) -> int:
        """Run the worker to successful completion, restarting on failure.
        Returns the number of restarts performed; raises RuntimeError when
        max_restarts is exhausted."""
        proc = self.spawn()
        spawned = time.time()
        while True:
            rc = proc.poll()
            if rc == 0:
                return self.restarts
            failed = rc is not None          # crashed / killed
            # staleness is measured from the last heartbeat OR the spawn,
            # whichever is later: a fresh worker gets a full timeout of
            # startup grace before it must have touched the file
            grace = (time.time() - spawned) <= self.stale_timeout_s
            if not failed and not grace and self.hb.stale(
                    self.stale_timeout_s):
                # hung: kill the EXACT pid we spawned (never a pattern)
                proc.kill()
                proc.wait()
                failed = True
            if failed:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"worker failed {self.restarts} times; giving up")
                proc = self.spawn()
                spawned = time.time()
            time.sleep(self.poll_s)
