"""Semantic object-pose layer (port of visma_tpu/semantic): CEM pose
refinement over batched render + edge scoring, and per-object track
management from bounding-box detections with result.json export."""

from visma_tpu_torch.semantic.cem import (refine_pose_cem,
                                          refine_pose_cem_batched)
from visma_tpu_torch.semantic.mapper import ObjectTrack, SemanticMapper

__all__ = ["refine_pose_cem", "refine_pose_cem_batched",
           "ObjectTrack", "SemanticMapper"]
