"""Command-line tools mirroring the reference executables (port of part of
visma_tpu/cli). undistort_images, run_vio, evaluate and annotate run on the
CUDA card unless `--device cpu` is given; example_load and example_dump
work on the host only.

  python -m visma_tpu_torch.cli.example_load <dataroot>          (example_load)
  python -m visma_tpu_torch.cli.example_dump <dataroot> <out>    (example_dump)
  python -m visma_tpu_torch.cli.undistort_images <dir>           (undistort_images)
  python -m visma_tpu_torch.cli.run_vio ...                      (the filter)
  python -m visma_tpu_torch.cli.evaluate <tool.json>             (example_evaluate)
  python -m visma_tpu_torch.cli.annotate <scan.ply> <cad> <models...>

Not ported yet: generate_depthmaps, render_depth, run_semantic, visualize,
show_2dmap, prepare_sfmlearner; `run_vio --ba` (it needs ba/ and dist/).
"""
