"""Batched mesh renderer: depth / mask / edge without OpenGL (port of
visma_tpu/render)."""

from visma_tpu_torch.render.camera import Intrinsics, to_gl_depth
from visma_tpu_torch.render.likelihood import (occlusion_aware_edge_score,
                                               scene_depth, score_hypotheses)
from visma_tpu_torch.render.raster import (MultiMeshRenderer, Renderer,
                                           rasterize_depth_brute,
                                           rasterize_depth_chunked,
                                           sort_faces_morton)

__all__ = [
    "Intrinsics", "to_gl_depth", "Renderer", "MultiMeshRenderer",
    "rasterize_depth_brute", "rasterize_depth_chunked",
    "sort_faces_morton", "scene_depth", "score_hypotheses",
    "occlusion_aware_edge_score",
]
