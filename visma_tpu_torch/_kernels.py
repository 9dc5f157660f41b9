"""Build and load the port's CUDA kernels.

The `.cu` sources under `csrc/` are compiled by `nvcc` for Hopper
(`sm_90a`) into one shared library with a plain C interface, loaded with
`ctypes`. The build runs on the first call of `library()`, never at import,
into `build/visma_tpu_torch/<hash of sources and flags>/` at the root of the
checkout (listed in `.gitignore`), so a changed source rebuilds and an
unchanged one is loaded as it is.

Each C entry point launches on the stream it is given, allocates nothing
and returns the `cudaGetLastError()` code; `check` raises on a non-zero
code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("corner_score.cu", "lk_level.cu", "chunk_raster.cu",
           "tri_setup.cu", "depth_edge.cu", "bilinear_remap.cu",
           "stage_mark.cu")
BUILD_ROOT = _PKG.parent / "build" / "visma_tpu_torch"
LIB_NAME = "libvisma_tpu_torch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the kernels then round as the
    # plain PyTorch versions do (see csrc/corner_score.cu)
    "-fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (img, out, H, W, border, min_response, cells or NULL, cell,
    #  cell_score, cell_idx, cell_xy, vec, stream)
    "vt_corner_score": (_P, _P, _I, _I, _I, _F, _P, _I, _P, _P, _P, _I, _P),
    # (imgT, imgI, H, W, orgT, orgI, stT, sI0, u, stat, K, win, radius,
    #  iters, stream)
    "vt_lk_level": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _P),
    # (level table by reference, pts, valid, new_pts, ok, K, radius, iters,
    #  max_residual, fb_thresh, stream)
    "vt_lk_track": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # (planes, ids, counts, out, nc, H, W, inv_near, inv_far, stream)
    "vt_chunk_raster_frame": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # (planes, ids, counts, out, B, nc, H, W, inv_near, inv_far, stream)
    "vt_chunk_raster_batched": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # (Cs, mesh or NULL, mesh64, M, T, poses, origins or NULL, planes, bbox,
    #  ids, counts, B, nc, H, W, sub, fx, fy, cx, cy, z_near, z_far, stream)
    "vt_tri_setup": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _F, _F, _F, _F, _F, _F, _P),
    # (depth, out, B, H, W, lo, range, border, vec, stream)
    "vt_depth_edge": (_P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    # (depth, occ or NULL, occ_stride, dt, dt_stride, obs, obs_stride,
    #  mass or NULL, mass_stride, mass_value, partial, scores, n, S, H, W,
    #  radius, lo, range, border, tau, coverage_weight, vec, stream)
    "vt_edge_score": (_P, _P, _I, _P, _I, _P, _I, _P, _I, _F, _P, _P, _I, _I,
                      _I, _I, _I, _F, _F, _I, _F, _F, _I, _P),
    # (img, table, out, branch or NULL, B, H, W, C, oh, ow, is_u8, stream)
    "vt_bilinear_remap": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (mark id, stream); the number of marks; load every mark's function
    "vt_stage_mark": (_I, _P),
    "vt_stage_marks": (),
    "vt_stage_mark_load": (),
}


def nvcc_path() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH; raises when neither
    exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build() -> Path:
    """Compile the library if this source hash has no build yet; returns
    its path. The compiler's output (with `-Xptxas -v`: registers, shared
    memory and spills of each kernel) goes to `build.log` beside it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    objs = [out_dir / f"{Path(s).stem}.{os.getpid()}.o" for s in SOURCES]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    log = []

    def finish(cmd, returncode, output):
        log.append(" ".join(cmd) + "\n" + output)
        (out_dir / "build.log").write_text("\n".join(log))
        if returncode != 0:
            raise RuntimeError(f"nvcc failed ({returncode}):\n"
                               + "\n".join(log))

    try:
        # one nvcc per source, all started together, then one link
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outputs = [p.communicate()[0] for p in procs]
        for c, p, o in zip(cmds, procs, outputs):
            finish(c, p.returncode, o)
        link = [nvcc, "-shared", "-o", tmp, *map(str, objs)]
        done = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        finish(link, done.returncode, done.stdout)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    finally:
        for f in (tmp, *objs):
            if os.path.exists(f):
                os.remove(f)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with argument types declared (builds on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current PyTorch stream on `t`'s device (a CUDA
    tensor), read without building a Stream object: a few microseconds
    less a launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def vec4(W: int, *tensors: torch.Tensor) -> int:
    """1 when rows of width W can be read as float4: W a multiple of 4 and
    every tensor's data 16-byte aligned."""
    return int(W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


# The kernel wrappers, each with a `launches` attribute that it raises by
# one where it launches its kernel. A CUDA graph replays launches without
# running that Python: the runners of `utils.graphs` take the launches of a
# capture back out (`take_back_launches`) and adds them once a replay
# (`add_launches`), so a counter counts the launches the device ran.
_COUNTED = []


def counted(fn):
    """Register a kernel wrapper's launch counter, `fn.launches`, at 0."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    return {fn: fn.launches for fn in _COUNTED}


def take_back_launches(before: dict) -> dict:
    """The launches counted since `launch_counts()` gave `before`, taken
    back out of the counters: {wrapper: launches} of those that counted."""
    delta = {fn: fn.launches - before.get(fn, 0) for fn in _COUNTED}
    for fn, d in delta.items():
        fn.launches -= d
    return {fn: d for fn, d in delta.items() if d}


def add_launches(delta: dict) -> None:
    for fn, d in delta.items():
        fn.launches += d


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
