"""Device ms a frame of the operations that are not the port's hand
kernels: the CEM's set-up, the distance transform, the sort and the refit."""
from portbench.readers import torch_ops_ms_per_unit as read  # noqa: F401
