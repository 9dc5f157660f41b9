"""Scene synthesis and mesh I/O: the port's own numpy copies of the
reference's `io.synthetic`, `io.synthetic_images`, `io.procedural` and
`io.mesh` modules. Imports neither torch nor jax."""

from visma_tpu_torch.io.mesh import (load_mesh, load_obj, load_ply, save_obj,
                                     save_ply)

__all__ = ["load_mesh", "save_obj", "save_ply", "load_obj", "load_ply"]
