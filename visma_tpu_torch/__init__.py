"""visma_tpu_torch: the VIO slice of visma_tpu in PyTorch, with hand-written
CUDA kernels for Hopper.

A port of the JAX package `visma_tpu`, which stays the reference. It
imports torch and never jax; it takes the numpy-only `visma_tpu.proto` and
`visma_tpu.io` modules as they are. The layout mirrors the reference:

  geom/      rodrigues, hat, vee
  utils/     health-gate utilities
  filter/    MSCKF: config, state, IMU propagation, triangulation, update
  frontend/  pyramid, corner detection (kernel csrc/corner_score.cu),
             fused pyramidal LK (kernel csrc/lk_level.cu), track management
  image/     Sobel / Shi-Tomasi stencils (the corner kernel's plain twin)
  pipeline.py  VioPipeline: images + IMU -> trajectory
  convert.py   state carried between the reference and the port
  _kernels.py  nvcc build and ctypes loading of csrc/*.cu

A kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor, or raises.
"""

__version__ = "0.1.0"
