"""Distributed execution layer: meshes over torch.distributed and sharded
BA (port of visma_tpu/dist).

The reference runs one controller: `sharded_ba_solve(prob, mesh)` is
called once and returns global arrays. torch.distributed runs one process
a rank, so the port's contract, which keeps the reference's signatures and
results, is:

  * every rank of the mesh calls a solver with the same whole problem, on
    the rank's device (`mesh.device`);
  * each rank takes its own landmark shard (or, in submap, its own chunk);
  * every rank gets the whole solution back: the landmark shards are put
    together by all_gather, and the replicated poses and cost history are
    identical on every rank, bit for bit.

The reference's `psum` is `torch.distributed.all_reduce(SUM)` on the
mesh's group. Without a process group the mesh has one rank and the
reduction is the identity: the one-device case, which `run_vio --ba
sharded` gets when it runs as a single process. No collective falls back
to another backend or device: a group is made by `multihost.initialize`
(or `torch.distributed.init_process_group`) with the backend asked for.
"""

from visma_tpu_torch.dist.mesh import device_count, make_mesh
from visma_tpu_torch.dist.pcg_ba import pcg_ba_solve
from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve, sharded_ba_step

__all__ = ["make_mesh", "device_count", "sharded_ba_solve",
           "sharded_ba_step", "pcg_ba_solve"]
