"""VISMA sequence loader (the port's own copy of visma_tpu/io/loader.py;
reference parity: src/dataloader.cpp:49-194).

Host-side ingest producing numpy (per-frame `grab`) and packed
struct-of-arrays feeds (`packed_packets`). Edge maps and the packed feed
decode with the native C++ decoder (`io.native_loader`, a ctypes binding
of native/vlslam_decoder.cc) when it builds, else with the pure-Python
codec of `visma_tpu_torch.proto`, as the reference's loader does.
Numerical conventions reproduced exactly:

* `gwc` is a row-major 3x4 [R|t] (dataloader.cpp:103-105);
* gravity rotation `Rg = exp([wg0, wg1, 0])` (dataloader.cpp:107-109);
* edge maps are float32 in [0,1], exposed both raw and as the u8 x255
  image the reference converts to (dataloader.cpp:19-22);
* point cloud / sparse depth use INSTATE|GOODDROP features only, depth is
  `(gwc^-1 * Xw).z` (dataloader.cpp:136-194).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from visma_tpu_torch.io.glob import glob_by_timestamp
from visma_tpu_torch.proto import BoundingBoxList, Dataset, EdgeMap, FeatureStatus


def load_edgemap(path: str) -> Optional[np.ndarray]:
    """Load an .edge protobuf file -> float32 (rows, cols) in [0,1], None
    when the file cannot be read or decoded.

    Uses the native C++ decoder when built; reference LoadEdgeMap
    (dataloader.cpp:13-27) additionally converts to u8 x255 — use
    `edge_u8` on the returned array for that view.
    """
    try:
        with open(path, "rb") as fp:
            data = fp.read()
        from visma_tpu_torch.io import native_loader

        if native_loader.available():
            return native_loader.load_edgemap_native(data)
        return EdgeMap.decode(data).as_image()
    except Exception:
        return None


def edge_u8(edge: np.ndarray) -> np.ndarray:
    """Reference convertTo(CV_8UC1, 255.0) semantics: scale + saturate-cast."""
    return np.clip(edge * 255.0, 0, 255).astype(np.uint8)


@dataclass
class FrameData:
    """One frame of a VISMA sequence (the reference `Grab` output tuple)."""

    index: int
    image: Optional[np.ndarray]  # (H, W, 3) BGR uint8, None if missing
    edgemap: Optional[np.ndarray]  # (H, W) float32 [0,1], None if missing
    bboxlist: Optional[BoundingBoxList]
    gwc: np.ndarray  # (3, 4) float32 camera-to-world
    Rg: np.ndarray  # (3, 3) float32 gravity-alignment rotation
    ts: float
    path: str = ""


class VlslamDatasetLoader:
    """Parity with reference VlslamDatasetLoader (dataloader.h:30-73).

    Parses `<dataroot>/dataset` (vlslam_pb.Dataset) and globs the per-frame
    `*.png` / `*.edge` / `*.bbox` side files sorted by timestamp name.
    """

    def __init__(self, dataroot: str):
        self.dataroot = dataroot
        with open(os.path.join(dataroot, "dataset"), "rb") as fp:
            self.dataset = Dataset.decode(fp.read())
        self.png_files = glob_by_timestamp(dataroot, ".png")
        self.edge_files = glob_by_timestamp(dataroot, ".edge")
        self.bbox_files = glob_by_timestamp(dataroot, ".bbox")
        # reference uses png count as the sequence size (dataloader.cpp:77);
        # fall back to packet count for image-less (synthetic) sequences.
        self.size = len(self.png_files) if self.png_files else len(self.dataset.packets)

    def __len__(self) -> int:
        return self.size

    # -- per-frame access ----------------------------------------------------
    def pose(self, i: int) -> np.ndarray:
        """(3,4) float32 gwc of frame i (row-major reshape of packet.gwc)."""
        return np.asarray(
            self.dataset.packets[i].gwc, dtype=np.float32
        ).reshape(3, 4)

    def gravity_rotation(self, i: int) -> np.ndarray:
        """Rg = exp(hat([wg0, wg1, 0])) as (3,3) float32."""
        from scipy.spatial.transform import Rotation

        wg = np.asarray(self.dataset.packets[i].wg, dtype=np.float64)
        w = np.array([wg[0], wg[1], 0.0]) if wg.size >= 2 else np.zeros(3)
        return Rotation.from_rotvec(w).as_matrix().astype(np.float32)

    def grab(self, i: int, load_image: bool = True) -> FrameData:
        if i < 0 or i >= self.size:
            raise IndexError(f"frame {i} out of range [0, {self.size})")
        packet = self.dataset.packets[i]

        image = None
        path = ""
        if load_image and i < len(self.png_files):
            import cv2

            path = self.png_files[i]
            image = cv2.imread(path)

        edgemap = None
        if i < len(self.edge_files):
            edgemap = load_edgemap(self.edge_files[i])
            if edgemap is None:
                raise IOError(f"failed to load edge map @ {self.edge_files[i]}")

        bboxlist = None
        if i < len(self.bbox_files):
            with open(self.bbox_files[i], "rb") as fp:
                bboxlist = BoundingBoxList.decode(fp.read())

        return FrameData(
            index=i,
            image=image,
            edgemap=edgemap,
            bboxlist=bboxlist,
            gwc=self.pose(i),
            Rg=self.gravity_rotation(i),
            ts=packet.ts,
            path=path,
        )

    def grab_pointcloud(self, i: int, image: Optional[np.ndarray] = None
                        ) -> Dict[int, np.ndarray]:
        """{feature_id: [x, y, z, b, g, r]} for INSTATE|GOODDROP features
        (dataloader.cpp:136-164). Color is sampled from `image` (BGR) at the
        integer pixel location; zeros if no image given."""
        out: Dict[int, np.ndarray] = {}
        for f in self.dataset.packets[i].features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
                color = np.zeros(3, np.float32)
                if image is not None:
                    color = image[int(f.xp[1]), int(f.xp[0])].astype(np.float32)
                prev = out.get(f.id)
                if prev is not None:
                    # reference averages colors on duplicate ids (cpp:144-150)
                    color = np.floor((color + prev[3:]) / 2.0)
                out[f.id] = np.concatenate(
                    [np.asarray(f.xw[:3], np.float32), color]
                )
        return out

    def grab_sparse_depth(self, i: int) -> Dict[int, np.ndarray]:
        """{feature_id: [xp_x, xp_y, depth]} with depth = (gcw * Xw).z
        (dataloader.cpp:166-194)."""
        g = self.pose(i).astype(np.float64)
        R, t = g[:, :3], g[:, 3]
        out: Dict[int, np.ndarray] = {}
        for f in self.dataset.packets[i].features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
                Xc = R.T @ (np.asarray(f.xw[:3]) - t)
                out[f.id] = np.array([f.xp[0], f.xp[1], Xc[2]], np.float32)
        return out

    def grab_camera_info(self):
        return self.dataset.camera

    # -- packed device feed --------------------------------------------------
    def packed_packets(self, max_features: int = 256, native: bool = True
                       ) -> Dict[str, np.ndarray]:
        """Struct-of-arrays view of all packets, ready for
        `torch.as_tensor(..., device=...)`.

        `native=True` (default) routes through the C++ decoder when built
        (native/vlslam_decoder.cc), else the Python codec.

        Fixed-capacity feature tables: every frame carries `max_features`
        slots; FeatureStatus.EMPTY (= 0, the proto mask value) marks unused
        slots. Returns dict with:
          ts        (N,)      float64
          gwc       (N,3,4)   float32
          wg        (N,2)     float32
          feat_id   (N,F)     int64     (-1 in empty slots)
          feat_status (N,F)   int32
          feat_xp   (N,F,2)   float32
          feat_xw   (N,F,3)   float32
        """
        if native:
            from visma_tpu_torch.io import native_loader

            if native_loader.available():
                with open(os.path.join(self.dataroot, "dataset"), "rb") as fp:
                    out = native_loader.packed_packets_native(
                        fp.read(), max_features=max_features)
                out.pop("feat_count", None)
                return out
        N, F = len(self.dataset.packets), max_features
        out = {
            "ts": np.zeros(N, np.float64),
            "gwc": np.zeros((N, 3, 4), np.float32),
            "wg": np.zeros((N, 2), np.float32),
            "feat_id": np.full((N, F), -1, np.int64),
            "feat_status": np.zeros((N, F), np.int32),
            "feat_xp": np.zeros((N, F, 2), np.float32),
            "feat_xw": np.zeros((N, F, 3), np.float32),
        }
        for i, p in enumerate(self.dataset.packets):
            out["ts"][i] = p.ts
            if len(p.gwc) == 12:
                out["gwc"][i] = np.asarray(p.gwc, np.float32).reshape(3, 4)
            if len(p.wg) >= 2:
                out["wg"][i] = p.wg[:2]
            for j, f in enumerate(p.features[:F]):
                out["feat_id"][i, j] = f.id
                out["feat_status"][i, j] = int(f.status)
                if len(f.xp) >= 2:
                    out["feat_xp"][i, j] = f.xp[:2]
                if len(f.xw) >= 3:
                    out["feat_xw"][i, j] = f.xw[:3]
        return out


def load_mesh_database(root: str, cat_json: str):
    """List of mesh names from a category json {"entries": [...]}
    (reference LoadMeshDatabase, dataloader.cpp:30-41)."""
    import json

    with open(os.path.join(root, cat_json)) as fp:
        return list(json.load(fp)["entries"])
