"""Binary map format {int32 rows, int32 cols, T data[rows*cols]}
(reference parity: core/utils.h:359-373 SaveMat; misc/show_2Dmap.py reader;
`.depth` files from example/generate_depthmaps.cpp)."""
from __future__ import annotations

import struct

import numpy as np


def save_mat(path: str, mat: np.ndarray) -> None:
    mat = np.ascontiguousarray(mat)
    if mat.ndim != 2:
        raise ValueError("save_mat expects a 2-D array")
    with open(path, "wb") as fp:
        fp.write(struct.pack("<ii", mat.shape[0], mat.shape[1]))
        fp.write(mat.tobytes())


def load_mat(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as fp:
        rows, cols = struct.unpack("<ii", fp.read(8))
        data = np.frombuffer(fp.read(), dtype=dtype)
    return data[: rows * cols].reshape(rows, cols).copy()
