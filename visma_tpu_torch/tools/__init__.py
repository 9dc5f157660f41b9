"""Twins of the reference's scripts outside its package (tools/*.py):
profilers and sweeps that drive the port's paths. Each is a module with a
`main(argv)`:

    python -m visma_tpu_torch.tools.<name> [--device cpu] ...

They run on the CUDA card unless given `--device cpu` and raise without
one. None writes into the repository by default: results go to stdout,
or to `--output`, whose default lies under `build/`.
"""
