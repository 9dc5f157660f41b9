"""Sliding-window bundle adjustment + pose-graph optimisation (port of
visma_tpu/ba): a Schur-complement reduced camera system solved on one
device; the landmark-sharded solvers of visma_tpu/dist reuse its pieces."""

from visma_tpu_torch.ba.problem import BaProblem, make_problem
from visma_tpu_torch.ba.gauss_newton import ba_solve, ba_step
from visma_tpu_torch.ba.pose_graph import pose_graph_solve

__all__ = ["BaProblem", "make_problem", "ba_solve", "ba_step",
           "pose_graph_solve"]
