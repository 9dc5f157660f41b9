"""Triangle-mesh I/O: OBJ and PLY (reference parity: core/utils.cpp:114-135
LoadMesh via libigl; igl::writeOBJ in visualization.cpp).

Self-contained parsers (no libigl / Open3D): OBJ v/f records (polygon faces
fan-triangulated, negative indices resolved) and PLY ascii +
binary_little_endian with x/y/z vertex properties and vertex_indices faces.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (V float32 (n,3), F int32 (m,3)), dispatching on extension
    like the reference (utils.cpp:125-130)."""
    if ".obj" in path:
        return load_obj(path)
    if ".ply" in path:
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r", errors="replace") as fp:
        for line in fp:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = int(tok.split("/")[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    V = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    F = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return V, F


def save_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    with open(path, "w") as fp:
        for v in np.asarray(V):
            fp.write(f"v {v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        for f in np.asarray(F):
            fp.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as fp:
        data = fp.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(type, propname)...])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    if fmt == "ascii":
        return _parse_ply_ascii(body.decode("ascii", errors="replace"), elements)
    if fmt == "binary_little_endian":
        return _parse_ply_binary(body, elements)
    raise ValueError(f"unsupported PLY format {fmt}")


_PLY_DTYPE = {
    "float": ("<f4", 4), "float32": ("<f4", 4), "double": ("<f8", 8),
    "float64": ("<f8", 8), "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4), "short": ("<i2", 2),
    "ushort": ("<u2", 2), "int16": ("<i2", 2), "uint16": ("<u2", 2),
    "char": ("<i1", 1), "uchar": ("<u1", 1), "int8": ("<i1", 1),
    "uint8": ("<u1", 1),
}


def _parse_ply_ascii(text: str, elements) -> Tuple[np.ndarray, np.ndarray]:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    pos = 0
    V = np.zeros((0, 3), np.float32)
    F = np.zeros((0, 3), np.int32)
    for name, count, props in elements:
        chunk = lines[pos : pos + count]
        pos += count
        if name == "vertex":
            names = [p[1] for p in props if p[0] != "list"]
            cols = {n: i for i, n in enumerate(names)}
            arr = np.array([[float(x) for x in ln.split()[: len(names)]] for ln in chunk])
            V = arr[:, [cols["x"], cols["y"], cols["z"]]].astype(np.float32)
        elif name == "face":
            faces = []
            for ln in chunk:
                toks = [int(float(x)) for x in ln.split()]
                n = toks[0]
                idx = toks[1 : 1 + n]
                for k in range(1, n - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            F = np.asarray(faces, np.int32).reshape(-1, 3)
    return V, F


def _parse_ply_binary(body: bytes, elements) -> Tuple[np.ndarray, np.ndarray]:
    off = 0
    V = np.zeros((0, 3), np.float32)
    F = np.zeros((0, 3), np.int32)
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if not has_list:
            dtype = np.dtype([(p[1], _PLY_DTYPE[p[0]][0]) for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
            off += dtype.itemsize * count
            if name == "vertex":
                V = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=-1
                ).astype(np.float32)
        else:
            faces = []
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cnt_t, idx_t = _PLY_DTYPE[p[1]], _PLY_DTYPE[p[2]]
                        n = int(np.frombuffer(body, cnt_t[0], 1, off)[0])
                        off += cnt_t[1]
                        idx = np.frombuffer(body, idx_t[0], n, off)
                        off += idx_t[1] * n
                        if name == "face":
                            for k in range(1, n - 1):
                                faces.append([idx[0], idx[k], idx[k + 1]])
                    else:
                        off += _PLY_DTYPE[p[0]][1]
            if name == "face":
                F = np.asarray(faces, np.int32).reshape(-1, 3)
    return V, F


def save_ply(path: str, V: np.ndarray, F: np.ndarray = None,
             colors: np.ndarray = None, binary: bool = True) -> None:
    """Write a point cloud or mesh as PLY (used for augmented_view.ply
    parity, evaluation.cpp:240)."""
    V = np.asarray(V, np.float32).reshape(-1, 3)
    n = len(V)
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if F is not None:
        header += [f"element face {len(F)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as fp:
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if colors is not None:
                c = np.asarray(colors).reshape(-1, 3).astype(np.uint8)
                rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"], rec["rgb"] = V, c
                fp.write(rec.tobytes())
            else:
                fp.write(V.astype("<f4").tobytes())
            if F is not None:
                Fa = np.asarray(F, "<i4").reshape(-1, 3)
                rec = np.zeros(len(Fa), dtype=[("n", "u1"), ("idx", "<i4", 3)])
                rec["n"], rec["idx"] = 3, Fa
                fp.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{V[i,0]:.8g} {V[i,1]:.8g} {V[i,2]:.8g}"
                if colors is not None:
                    c = np.asarray(colors[i], np.int32)
                    row += f" {c[0]} {c[1]} {c[2]}"
                fp.write((row + "\n").encode("ascii"))
            if F is not None:
                for f in np.asarray(F, np.int32):
                    fp.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode("ascii"))
