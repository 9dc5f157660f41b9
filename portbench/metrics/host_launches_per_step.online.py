"""The host's kernel launches, copies, sets and graph launches a step
(CallGraph's copies in and out)."""
from portbench.readers import host_launches_per_unit as read  # noqa: F401
