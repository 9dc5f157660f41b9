"""The host's kernel launches, copies, sets and graph launches a frame
(StepGraph's copies around each replay)."""
from portbench.readers import host_launches_per_unit as read  # noqa: F401
