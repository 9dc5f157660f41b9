"""% of the traced device span (idle_share's denominator) in which the
device is idle while the host's innermost program span is one of the
graph runtime's (`graph.copy_in`, `graph.launch`, `graph.copy_out`,
`graph.capture`)."""
from portbench.program_trace import idle_in_graph_runtime_share as read  # noqa: F401
