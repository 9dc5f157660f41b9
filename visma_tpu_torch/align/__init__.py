"""Point-cloud / scene alignment (port of visma_tpu/align; reference parity:
src/constrained_ICP.cpp, src/evaluation.cpp registration path,
src/annotation.cpp). `registration` is the port's numpy copy."""

from visma_tpu_torch.align.umeyama import umeyama, umeyama_4dof
from visma_tpu_torch.align.nn import nearest_neighbors
from visma_tpu_torch.align.voxel import voxel_downsample
from visma_tpu_torch.align.icp import icp, IcpResult
from visma_tpu_torch.align.registration import (
    find_correspondences, register_scenes, optimize_alignment,
)
from visma_tpu_torch.align.annotation import (register_model_to_scene,
                                              find_plane_normal)

__all__ = [
    "umeyama", "umeyama_4dof", "nearest_neighbors", "voxel_downsample",
    "icp", "IcpResult", "find_correspondences", "register_scenes",
    "optimize_alignment", "register_model_to_scene", "find_plane_normal",
]
