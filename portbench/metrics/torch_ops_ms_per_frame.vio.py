"""Device ms a frame of the operations that are not the port's hand
kernels: the filter's and the tracker glue's PyTorch ops."""
from portbench.readers import torch_ops_ms_per_unit as read  # noqa: F401
