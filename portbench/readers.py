"""Arithmetic the metric readers share, over a traced window
(`trace_read.Window`) and the run's own counts."""
from __future__ import annotations

import numpy as np

from portbench.roofline import hand_kernel


def traced(run) -> bool:
    return run.window is not None and run.trace_frames


def idle_share(run):
    """% of the traced device span, from the end of the marker kernel to
    the end of the last operation, in which no operation ran: the gaps
    between the merged device intervals, from the trace alone. The
    profiler slows the host's side of a launch, so a host-bound unit reads
    more idle traced than it runs untraced; `notes.trace` gives the
    untraced unit's wall time beside the traced one."""
    if not traced(run):
        return None
    span = run.window.span_s()
    if span <= 0:
        return None
    return 100.0 * (span - run.window.busy_s()) / span


def torch_ops_ms_per_unit(run):
    """Device ms of every operation that is not a hand kernel, a unit."""
    if not traced(run):
        return None
    s = sum(b - a for name, a, b in run.window.ops if not hand_kernel(name))
    return s / 1e3 / run.trace_frames


def device_ops_per_unit(run):
    """Device operations a unit, the window held to the host's count."""
    if not traced(run):
        return None
    return len(run.window.ops) / run.trace_frames


def host_launches_per_unit(run):
    """The host's kernel launches, copies, sets and graph launches a unit."""
    if not traced(run):
        return None
    w = run.window
    return (w.host_launches + w.graph_launches) / run.trace_frames


def percentile(values, q: float):
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
