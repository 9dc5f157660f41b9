"""Evaluation suite (port of visma_tpu/eval; reference parity:
src/evaluation.cpp, src/visualization.cpp, include/geometry.h).
`sampling` and `assembly` are the port's numpy copies."""

from visma_tpu_torch.eval.metrics import (
    ErrorMetric, compute_error_metric, measure_surface_error,
    measure_pose_error, point_mesh_distances,
)
from visma_tpu_torch.eval.sampling import sample_mesh
from visma_tpu_torch.eval.assembly import assemble_scene
from visma_tpu_torch.eval.evaluate import (mesh_alignment,
                                           quantitative_evaluation)

__all__ = [
    "ErrorMetric", "compute_error_metric", "measure_surface_error",
    "measure_pose_error", "point_mesh_distances", "sample_mesh",
    "assemble_scene", "mesh_alignment", "quantitative_evaluation",
]
