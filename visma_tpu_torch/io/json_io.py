"""JSON config/result helpers (the port's own copy of visma_tpu/io/json_io.py;
reference parity: core/utils.h:296-344, core/utils.cpp:139-164)."""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np


def strip_json_comments(text: str) -> str:
    """Remove ``//`` line comments and ``/* */`` block comments outside of
    string literals, replacing them with spaces so offsets/line numbers in
    error messages stay meaningful.

    The reference loads its configs with jsoncpp (core/utils.cpp:148), which
    accepts comments; the shipped cfg/tool.json is full of them, so plain
    json.load crashes on the one config the reference actually uses.
    """
    out = []
    i, n = 0, len(text)
    in_string = False
    while i < n:
        c = text[i]
        if in_string:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_string = False
            i += 1
        elif c == '"':
            in_string = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                out.append(" ")
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            out.append("  ")
            i += 2
            while i < n and not (text[i] == "*" and i + 1 < n
                                 and text[i + 1] == "/"):
                out.append("\n" if text[i] == "\n" else " ")
                i += 1
            if i < n:
                out.append("  ")
                i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def load_json(path: str) -> Dict[str, Any]:
    """Load JSON, tolerating jsoncpp-style comments (utils.cpp:148)."""
    with open(path, "r") as fp:
        text = fp.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return json.loads(strip_json_comments(text))


def save_json(obj: Dict[str, Any], path: str, indent: int = 2) -> None:
    with open(path, "w") as fp:
        json.dump(obj, fp, indent=indent)


def merge_json(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge b into a, in place (reference MergeJson: keys of b
    overwrite a unless both sides are objects, utils.cpp:139-146)."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return a
    for key, val in b.items():
        if isinstance(a.get(key), dict) and isinstance(val, dict):
            merge_json(a[key], val)
        else:
            a[key] = val
    return a


def matrix_from_json(v: Dict[str, Any], key: str, rows: int = 3, cols: int = 4,
                     layout: str = "one_dim") -> np.ndarray:
    """Read a rows x cols matrix stored under `key` (utils.h:305-322).

    layout: "one_dim" (flat row-major list — the alignment.json / result.json
    convention), "row_major" (list of rows) or "col_major" (list of cols).
    """
    raw = v[key]
    if layout == "one_dim":
        return np.asarray(raw, dtype=np.float64)[: rows * cols].reshape(rows, cols)
    arr = np.asarray(raw, dtype=np.float64)
    if layout == "row_major":
        return arr[:rows, :cols]
    return arr[:cols, :rows].T


def matrix_to_json(d: Dict[str, Any], key: str, m: np.ndarray) -> None:
    """Write matrix as a flat row-major list (utils.h:333-339)."""
    d[key] = [float(x) for x in np.asarray(m, dtype=np.float64).ravel()]
