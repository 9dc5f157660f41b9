"""ctypes bridge to the native C++ vlslam decoder (native/vlslam_decoder.cc;
the port's copy of visma_tpu/io/native_loader.py). Host code: it decodes
on the CPU whatever device the port runs on.

Builds the shared library on first use (`make -C native`, g++, no external
deps) under native/.build.lock, and caches it next to the sources. Callers
check `available()`, or call `VlslamDatasetLoader.packed_packets(native=...)`,
which takes the Python codec where the library cannot be built.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional

import numpy as np

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def _build() -> Optional[str]:
    so = os.path.join(_NATIVE_DIR, "libvlslam_decoder.so")
    src = os.path.join(_NATIVE_DIR, "vlslam_decoder.cc")
    if not os.path.exists(src):
        return None
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        try:
            import fcntl

            # serialize concurrent builders (pytest-xdist workers all
            # import on startup); the lock holder builds, the rest wait
            with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as fp:
                fcntl.flock(fp, fcntl.LOCK_EX)
                if (not os.path.exists(so) or
                        os.path.getmtime(so) < os.path.getmtime(src)):
                    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                                   capture_output=True)
        except Exception:
            return None
    return so if os.path.exists(so) else None


def _lib():
    global _LIB
    if _LIB is None:
        so = _build()
        if so is None:
            _LIB = False
            return None
        lib = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.vlslam_dataset_dims.argtypes = [
            u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.vlslam_dataset_dims.restype = ctypes.c_int
        lib.vlslam_decode_dataset.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.vlslam_decode_dataset.restype = ctypes.c_int
        lib.vlslam_edgemap_dims.argtypes = [
            u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.vlslam_edgemap_dims.restype = ctypes.c_int
        lib.vlslam_decode_edgemap.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.vlslam_decode_edgemap.restype = ctypes.c_int
        _LIB = lib
    return _LIB if _LIB is not False else None


def available() -> bool:
    return _lib() is not None


def _as_u8p(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def packed_packets_native(data: bytes, max_features: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
    """Decode a serialized Dataset into packed SoA arrays (same layout as
    VlslamDatasetLoader.packed_packets)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = ctypes.c_int64()
    maxf = ctypes.c_int64()
    if lib.vlslam_dataset_dims(_as_u8p(data), len(data),
                               ctypes.byref(n), ctypes.byref(maxf)):
        raise ValueError("malformed dataset buffer")
    N = n.value
    F = max_features or max(int(maxf.value), 1)

    out = {
        "ts": np.zeros(N, np.float64),
        "gwc": np.zeros((N, 3, 4), np.float32),
        "wg": np.zeros((N, 2), np.float32),
        "feat_id": np.full((N, F), -1, np.int64),
        "feat_status": np.zeros((N, F), np.int32),
        "feat_xp": np.zeros((N, F, 2), np.float32),
        "feat_xw": np.zeros((N, F, 3), np.float32),
    }
    feat_count = np.zeros(N, np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    rc = lib.vlslam_decode_dataset(
        _as_u8p(data), len(data), F,
        ptr(out["ts"], ctypes.c_double), ptr(out["gwc"], ctypes.c_float),
        ptr(out["wg"], ctypes.c_float), ptr(out["feat_id"], ctypes.c_int64),
        ptr(out["feat_status"], ctypes.c_int32),
        ptr(out["feat_xp"], ctypes.c_float),
        ptr(out["feat_xw"], ctypes.c_float),
        ptr(feat_count, ctypes.c_int32))
    if rc:
        raise ValueError("malformed dataset buffer")
    out["feat_count"] = feat_count
    return out


def load_edgemap_native(data: bytes) -> np.ndarray:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    r = ctypes.c_int64()
    c = ctypes.c_int64()
    if lib.vlslam_edgemap_dims(_as_u8p(data), len(data), ctypes.byref(r),
                               ctypes.byref(c)):
        raise ValueError("malformed edgemap")
    rows, cols = int(r.value), int(c.value)
    out = np.zeros(rows * cols, np.float32)
    if lib.vlslam_decode_edgemap(_as_u8p(data), len(data),
                                 out.ctypes.data_as(
                                     ctypes.POINTER(ctypes.c_float)),
                                 rows * cols):
        raise ValueError("malformed edgemap")
    return out.reshape(rows, cols)
