"""Command-line tools mirroring the reference executables (port of
visma_tpu/cli, every tool). undistort_images, run_vio (with `--no-imu` and
`--ba dense|sharded`), evaluate, annotate, render_depth, run_semantic and
visualize's `--animate` run on the CUDA card unless `--device cpu` is
given; example_load, example_dump, generate_depthmaps, prepare_sfmlearner,
show_2dmap and visualize's static figure are host work and take no device.

  python -m visma_tpu_torch.cli.example_load <dataroot>          (example_load)
  python -m visma_tpu_torch.cli.example_dump <dataroot> <out>    (example_dump)
  python -m visma_tpu_torch.cli.undistort_images <dir>           (undistort_images)
  python -m visma_tpu_torch.cli.run_vio ...                      (the filter)
  python -m visma_tpu_torch.cli.evaluate <tool.json>             (example_evaluate)
  python -m visma_tpu_torch.cli.annotate <scan.ply> <cad> <models...>
  python -m visma_tpu_torch.cli.render_depth <config.json>       (render_depth)
  python -m visma_tpu_torch.cli.run_semantic --dataroot D --models M | --synthetic N
  python -m visma_tpu_torch.cli.visualize <dataroot> [--animate DIR]
  python -m visma_tpu_torch.cli.generate_depthmaps <cloud.xyz> <alignment> <dataroot>
  python -m visma_tpu_torch.cli.prepare_sfmlearner <dataroot> <out>
  python -m visma_tpu_torch.cli.show_2dmap <map.bin> [--output png]
"""
