"""Kernels' shares of their rooflines.

One module a kernel, `portbench/roofline/<kernel>.py`, names the kernel's
device functions (`DEVICE_NAMES`: the function's name as its demangled
signature gives it, with its template arguments where only some
instantiations are this kernel, without where all are; the first is
counted as the launches) and counts the work of that many launches from
the cell's shapes (`work(shapes, launches) -> (bytes, flops)`):
each input byte read once and each output byte written once, and the
operations these inputs need. The count is the work, whatever implements
it. The bounds are the published peaks of one NVIDIA H100 SXM (data
sheet, dense, at its 700 W limit), the rates chip_smoke.py's bound
arithmetic uses at 43be5d3.

These modules are also the one list of the port's hand-written kernels: a
device operation that none of them names is counted with the op chains
(`hand_kernel`), so a kernel that a later change brings onto a cell's path
comes with a module of its own here.
"""
from __future__ import annotations

import importlib
import pkgutil
from functools import lru_cache

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(n_bytes: float, n_flop: float):
    """(seconds, "bytes" or "flops"): the larger of the two bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flop = n_flop / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "flops")


def kernel_names(op: str) -> tuple:
    """The names a device operation answers to: its function's name with
    its template arguments and without, namespaces and the argument list
    dropped. `void (anonymous namespace)::chunk_raster_kernel<16>(float
    const*, ...)` answers to `chunk_raster_kernel<16>` and
    `chunk_raster_kernel`."""
    s = op.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    s = s.split("(", 1)[0].strip()
    head, sep, args = s.partition("<")
    full = head.rsplit("::", 1)[-1] + sep + args
    return full, full.split("<", 1)[0]


def matches(op: str, device_names) -> bool:
    return any(n in device_names for n in kernel_names(op))


@lru_cache(maxsize=None)
def kernels() -> dict:
    """{module name: its DEVICE_NAMES}, for every module of this package."""
    return {m.name: tuple(importlib.import_module(
        f"{__name__}.{m.name}").DEVICE_NAMES)
        for m in pkgutil.iter_modules(__path__)}


def hand_kernel(op: str) -> bool:
    """Whether a device operation is one of the port's hand-written
    kernels: one that a module of this package names."""
    return any(matches(op, names) for names in kernels().values())


def share(run, kernel: str):
    """The kernel's launches in the traced window times one launch's bound,
    over the device time of those launches, in %; None where the window ran
    no such launch."""
    mod = importlib.import_module(f"portbench.roofline.{kernel}")
    if run.window is None:
        return None
    ops = [(name, (b - a) / 1e6) for name, a, b in run.window.ops
           if matches(name, mod.DEVICE_NAMES)]
    launches = sum(matches(name, mod.DEVICE_NAMES[:1]) for name, _ in ops)
    device_s = sum(t for _, t in ops)
    if not launches or device_s <= 0:
        return None
    t, by = bound_s(*mod.work(run.shapes, launches))
    run.notes[f"{kernel}_roofline"] = {
        "bound_by": by, "bound_s": t, "launches": launches,
        "device_s": device_s, "power_limit_w": run.power_limit_w}
    return 100.0 * t / device_s
