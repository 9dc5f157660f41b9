"""Image stencils for the VIO slice (port of part of visma_tpu/image)."""

from visma_tpu_torch.image.edges import (shi_tomasi_response,
                                         sobel_gradients)

__all__ = ["shi_tomasi_response", "sobel_gradients"]
