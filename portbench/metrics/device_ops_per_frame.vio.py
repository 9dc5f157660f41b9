"""Device operations a frame, the traced window held to the host's
launches and the graph replays' recorded operations."""
from portbench.readers import device_ops_per_unit as read  # noqa: F401
