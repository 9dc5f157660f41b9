"""Image stencils (port of part of visma_tpu/image)."""

from visma_tpu_torch.image.edges import (depth_edge, depth_edge_plain,
                                         linearize_gl_depth,
                                         shi_tomasi_response,
                                         sobel_gradients, soft_threshold)

__all__ = ["depth_edge", "depth_edge_plain", "linearize_gl_depth",
           "shi_tomasi_response", "sobel_gradients", "soft_threshold"]
