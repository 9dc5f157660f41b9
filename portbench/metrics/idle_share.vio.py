"""% of the traced device span (the marker kernel's end to the last
operation's end) with no operation on the device, from the trace alone."""
from portbench.readers import idle_share as read  # noqa: F401
