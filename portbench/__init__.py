"""The benchmark of visma_tpu_torch, the PyTorch and CUDA port of VISMA's
visual-inertial odometry and semantic mapping. See BENCHMARK.json at the
root of the repository and `python -m portbench.run --help`."""
