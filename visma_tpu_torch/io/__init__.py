"""Dataset and asset I/O: the port's own numpy copies of the reference's
`io.glob`, `io.loader`, `io.json_io`, `io.binary`, `io.mesh`,
`io.synthetic`, `io.synthetic_images` and `io.procedural` modules. Imports
neither torch nor jax. The reference's ctypes binding of the C++ decoder
(`io/native_loader.py`) is not ported: the loader decodes with the Python
codec of `visma_tpu_torch.proto`."""

from visma_tpu_torch.io.binary import load_mat, save_mat
from visma_tpu_torch.io.glob import glob_by_timestamp
from visma_tpu_torch.io.json_io import (load_json, matrix_from_json,
                                        matrix_to_json, merge_json, save_json)
from visma_tpu_torch.io.loader import (FrameData, VlslamDatasetLoader,
                                       load_edgemap)
from visma_tpu_torch.io.mesh import (load_mesh, load_obj, load_ply, save_obj,
                                     save_ply)

__all__ = [
    "glob_by_timestamp", "VlslamDatasetLoader", "FrameData", "load_edgemap",
    "load_mesh", "save_obj", "save_ply", "load_obj", "load_ply",
    "load_json", "save_json", "merge_json", "matrix_from_json",
    "matrix_to_json", "save_mat", "load_mat",
]
