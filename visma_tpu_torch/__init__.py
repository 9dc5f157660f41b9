"""visma_tpu_torch: visma_tpu in PyTorch, with hand-written CUDA kernels for
Hopper. So far the VIO main path, the semantic mapping path and the
sequence-ingest path (raw frames -> undistort -> VIO, and its CLIs).

A port of the JAX package `visma_tpu`, which stays the reference. It
imports torch and never jax, and nothing of `visma_tpu`: what it needs of
the reference's numpy-only modules (`proto`, `io`) it keeps as its own
copies. The layout mirrors the reference:

  geom/      rodrigues, hat, vee, invrodrigues; SO3 / SE3 (lie.py)
  utils/     health-gate utilities, the device rule (resolve_device),
             Timer / device_trace, configure_platform
  proto/     vlslam dataclasses and wire codec (numpy)
  io/        sequence loader, glob, JSON and binary maps, synthetic scenes,
             procedural meshes, OBJ/PLY (numpy)
  filter/    MSCKF: config, state, IMU propagation, triangulation, update;
             feed.pack_frames (numpy)
  frontend/  pyramid, corner detection and the per-cell pick (kernel
             csrc/corner_score.cu),
             fused pyramidal LK (kernel csrc/lk_level.cu), the windowed
             tracker (klt.py, plain PyTorch), track management
  image/     undistortion: ATAN / radial-tangential tables (undistort.py)
             and the bilinear remap (kernel csrc/bilinear_remap.cu);
             Sobel / Shi-Tomasi stencils (the corner kernel's plain twin),
             depth_edge (kernel csrc/depth_edge.cu)
  render/    camera, the chunked plane rasterizer (kernels
             csrc/chunk_raster.cu: one frame, and a batch of ROI windows),
             Renderer / MultiMeshRenderer, the edge likelihood (edge_score:
             kernel vt_edge_score in csrc/depth_edge.cu)
  semantic/  batched CEM pose refinement, SemanticMapper
  pipeline.py  VioPipeline: images + IMU -> trajectory
  cli/         undistort_images, run_vio, example_load, example_dump
  convert.py   state carried between the reference and the port
  _kernels.py  nvcc build and ctypes loading of csrc/*.cu

A kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor, or raises. An entry point runs on
the CUDA card unless the caller passes `device="cpu"`, and raises where no
card exists.
"""

__version__ = "0.3.0"
