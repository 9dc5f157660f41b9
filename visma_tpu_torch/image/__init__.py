"""Image kernels: undistortion remap + edge maps (port of visma_tpu/image;
reference parity: src/undistorter.cpp, render/shaders/edge_detection.frag)."""

from visma_tpu_torch.image.edges import (depth_edge, depth_edge_plain,
                                         linearize_gl_depth,
                                         shi_tomasi_response,
                                         sobel_gradients, soft_threshold)
from visma_tpu_torch.image.remap import bilinear_remap, bilinear_remap_plain
from visma_tpu_torch.image.undistort import (CORVIS_ATAN_CALIB, AtanModel,
                                             RadTanModel, Undistorter,
                                             corvis_undistorter,
                                             undistorter_from_file)

__all__ = [
    "AtanModel", "RadTanModel", "Undistorter", "undistorter_from_file",
    "corvis_undistorter", "CORVIS_ATAN_CALIB",
    "bilinear_remap", "bilinear_remap_plain",
    "depth_edge", "depth_edge_plain", "linearize_gl_depth", "soft_threshold",
    "sobel_gradients", "shi_tomasi_response",
]
