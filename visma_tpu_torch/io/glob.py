"""Directory globbing with timestamp ordering (reference core/utils.cpp:49-112)."""
from __future__ import annotations

import os
from typing import List


def glob_by_timestamp(directory: str, extension: str, prefix: str = "") -> List[str]:
    """List `<prefix><stem><extension>` files in `directory`, sorted by
    float(stem) when every stem parses as a float, else lexicographically.

    Matches reference Glob semantics (utils.cpp:49-112): VISMA sequences
    name frames by capture timestamp (e.g. `1520535134297896.png`), and
    frame order is the numeric order of those names.
    """
    suffix = extension if extension.startswith(".") else "." + extension
    stems = []
    for name in os.listdir(directory):
        if (
            len(name) > len(suffix) + len(prefix)
            and name.endswith(suffix)
            and name.startswith(prefix)
        ):
            stems.append(name[len(prefix) : len(name) - len(suffix)])
    try:
        stems.sort(key=float)
    except ValueError:
        stems.sort()
    return [os.path.join(directory, prefix + s + suffix) for s in stems]
