"""visma_tpu_torch: visma_tpu in PyTorch, with hand-written CUDA kernels for
Hopper. So far the VIO main path (with in-state SLAM landmarks), the
semantic mapping path, the sequence-ingest path (raw frames -> undistort ->
VIO, and its CLIs), the evaluation path (align/, eval/, the evaluate and
annotate tools), the trajectory-refinement path (ba/, Msckf.run_batched,
run_vio --ba dense) and the distributed layer (dist/, utils/checkpoint,
run_vio --ba sharded, dryrun.py).

A port of the JAX package `visma_tpu`, which stays the reference. It
imports torch and never jax, and nothing of `visma_tpu`: what it needs of
the reference's numpy-only modules (`proto`, `io`, `align.registration`,
`eval.sampling`, `eval.assembly`, `utils.term`) it keeps as its own copies.
The layout mirrors the reference:

  geom/      rodrigues, hat, vee, invrodrigues and their analytic
             Jacobians, project_so3; SO3 / SE3 (lie.py)
  utils/     health-gate utilities, the device rule (resolve_device),
             full_f32 (no TF32), with_blocks, tree_leaves, Timer /
             device_trace, configure_platform, TermColor, checkpoints in the
             reference's npz layout (checkpoint.py)
  ba/        bundle adjustment: the problem, Gauss-Newton with the Schur
             complement, the pose graph, the VIO -> BA loop (from_vio,
             numpy)
  dist/      torch.distributed: a process group as a 1-D mesh, the
             landmark-sharded dense and matrix-free PCG solvers, submap BA,
             the two-stage frontend/filter pipeline (two CUDA streams on one
             card), multihost (initialize, Heartbeat, Watchdog)
  proto/     vlslam dataclasses and wire codec (numpy)
  io/        sequence loader, glob, JSON and binary maps, synthetic scenes,
             procedural meshes, OBJ/PLY (numpy)
  filter/    MSCKF: config, state, IMU propagation, triangulation, update,
             in-state SLAM landmarks (slam.py), Msckf.run and run_batched
             (B streams, one vmapped step a frame); feed.pack_frames (numpy)
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
  semantic/  batched CEM pose refinement, SemanticMapper (its CEM,
             retrieval and occluder executors replay captured CUDA graphs)
  align/     Umeyama, brute-force nearest neighbours, voxel grid, ICP,
             yaw-sweep annotation, scene registration (numpy)
  eval/      error metrics (point-to-mesh distance: SoA path and the
             pairwise oracle), quantitative evaluation, sampling and scene
             assembly (numpy)
  pipeline.py  VioPipeline: images + IMU -> trajectory
  utils/graphs.py  StepGraph: the sequence runners' step captured once into
               a CUDA graph and replayed a frame (graph=False: the loop);
               CallGraph: a function captured once an input shape and
               replayed a call (the semantic executors)
  cli/         undistort_images, run_vio, evaluate, annotate, example_load,
               example_dump
  convert.py   state carried between the reference and the port
  dryrun.py    the multichip dryrun's twin, the reference's gates
  _kernels.py  nvcc build and ctypes loading of csrc/*.cu

A kernel wrapper takes its plain PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor, or raises. An entry point runs on
the CUDA card unless the caller passes `device="cpu"`, and raises where no
card exists. A kernel wrapper's `launches` counter counts what the device
ran, CUDA graph replays included.
"""

__version__ = "0.3.0"
