"""Meshes over torch.distributed (port of visma_tpu/dist/mesh.py).

A JAX mesh is a set of devices that one controller drives. Here a mesh is
a process group: one process a rank, each rank on its own device (or, to
check the arithmetic on one card, several gloo ranks on that card). The
two collectives the solvers need are methods of the mesh, and the mesh
counts them, as the kernels count their launches: set `counts` to zeros
before a call and read it after. A solver whose steps replay a captured
CUDA graph hands `counts` to its runner (`utils.graphs`), which counts a
capture 0 and each replay the collectives its capture made, so the count
is the same graphed or eager.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from visma_tpu_torch.utils.graphs import wants_graph
from visma_tpu_torch.utils.misc import resolve_device


def _zero_counts() -> dict:
    return {"all_reduce": 0, "all_gather": 0}


@dataclass(eq=False)
class Mesh:
    """A 1-D mesh: `group` is the process group (None for the one-rank mesh
    of a process without one), `rank` this process's place in it (None on a
    rank the mesh leaves out), `size` its number of ranks, `device` where
    this rank computes."""

    group: Optional[dist.ProcessGroup]
    rank: Optional[int]
    size: int
    device: torch.device
    axis: str = "d"
    counts: dict = field(default_factory=_zero_counts)

    def _member(self) -> None:
        if self.rank is None:
            raise RuntimeError(
                f"this process (rank {dist.get_rank()} of the default group)"
                f" is not in the {self.size}-rank mesh")

    def shard_rank(self) -> int:
        """This rank's place in the mesh; raises on a rank left out."""
        self._member()
        return self.rank

    def graphed(self, graph: Optional[bool]) -> bool:
        """Whether a solver over this mesh runs its steps as a captured
        CUDA graph, from the solver's `graph` argument and the backend:

          * the one-rank mesh without a group captures: its collectives
            are the identity;
          * an nccl group captures: its collectives are device work on the
            card (the eager warm-up steps create the communicator before
            the capture);
          * a group of another backend (gloo) cannot: its collectives run
            on the host. `graph=None` then runs the eager loop, and
            `graph=True` on a CUDA device raises.

        This is a rule about the backend, not a fallback: a capture that
        fails raises `GraphCaptureError`. On the CPU nothing is captured:
        `graph=None` is the eager loop, `graph=True` runs the graph's
        static buffers, whatever the backend."""
        if self.device.type != "cuda":
            return wants_graph(graph, self.device)
        backend = None if self.group is None else dist.get_backend(self.group)
        captures = backend in (None, "nccl")
        if graph is None:
            return captures
        if graph and not captures:
            raise ValueError(f"a {backend} group cannot be captured into a "
                             "CUDA graph: its collectives run on the host")
        return bool(graph)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the mesh (the reference's `psum`), as a new
        tensor; the identity on a one-rank mesh without a group."""
        self._member()
        self.counts["all_reduce"] += 1
        if self.group is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, concatenated along dim 0 in rank order."""
        self._member()
        self.counts["all_gather"] += 1
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def device_count() -> int:
    """Ranks of the default process group (1 without one): the number of
    devices a mesh can span."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int = None, axis: str = "d",
              device=None) -> Mesh:
    """1-D mesh over the first `n_devices` ranks of the default group (all
    of them when None); every rank of the default group must call it, as
    `torch.distributed.new_group` asks. Without a process group it is the
    one-rank mesh. `device` is where this rank computes: None means the
    current CUDA device (the port's rule: `device="cpu"` to run on the
    CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a {n_devices}-rank mesh needs a process "
                             "group (multihost.initialize)")
        return Mesh(group=None, rank=0, size=1, device=dev, axis=axis)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    group = dist.group.WORLD if n == world \
        else dist.new_group(ranks=list(range(n)))
    me = dist.get_rank()
    return Mesh(group=group, rank=me if me < n else None, size=n,
                device=dev, axis=axis)
