"""vlslam message types (reference parity: protocols/vlslam.proto:1-73).

Plain dataclasses + encode/decode on the hand-rolled wire codec. Decode
accepts anything the reference's C++/Python readers would; encode emits
unpacked repeated scalars exactly like the proto2 C++ writer that produced
the VISMA dataset, so golden bytes round-trip.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from visma_tpu_torch.proto import wire


class FeatureStatus(enum.IntEnum):
    """Feature lifecycle of the upstream VIO filter (vlslam.proto:11-19).

    The MSCKF in visma_tpu/filter uses the same state machine; EMPTY is the
    mask value for fixed-capacity feature tables.
    """

    EMPTY = 0
    GOODDROP = 1
    KEEP = 2
    REJECT = 3
    INITIALIZING = 4
    READY = 5
    INSTATE = 6


@dataclass
class CameraInfo:
    rows: int = 0
    cols: int = 0
    parameters: np.ndarray = field(default_factory=lambda: np.zeros(0))  # fx, fy, cx, cy, ...

    def encode(self) -> bytes:
        buf = bytearray()
        wire.write_int(buf, 1, self.rows)
        wire.write_int(buf, 2, self.cols)
        for p in np.asarray(self.parameters, dtype=np.float64).ravel():
            wire.write_double(buf, 3, p)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "CameraInfo":
        f = wire.parse_fields(data)
        return cls(
            rows=wire.to_signed(wire.as_ints(f.get(1, [0]))[0]),
            cols=wire.to_signed(wire.as_ints(f.get(2, [0]))[0]),
            parameters=wire.as_doubles(f.get(3, [])),
        )


@dataclass
class Feature:
    id: int = 0
    status: FeatureStatus = FeatureStatus.EMPTY
    xp: np.ndarray = field(default_factory=lambda: np.zeros(0))  # pixel coords
    xw: np.ndarray = field(default_factory=lambda: np.zeros(0))  # world coords

    def encode(self) -> bytes:
        buf = bytearray()
        wire.write_int(buf, 1, self.id)
        wire.write_int(buf, 2, int(self.status))
        for v in np.asarray(self.xp, dtype=np.float64).ravel():
            wire.write_double(buf, 3, v)
        for v in np.asarray(self.xw, dtype=np.float64).ravel():
            wire.write_double(buf, 4, v)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Feature":
        f = wire.parse_fields(data)
        return cls(
            id=wire.to_signed(wire.as_ints(f.get(1, [0]))[0]),
            status=FeatureStatus(wire.as_ints(f.get(2, [0]))[0]),
            xp=wire.as_doubles(f.get(3, [])),
            xw=wire.as_doubles(f.get(4, [])),
        )


@dataclass
class Packet:
    """Per-frame VIO output: timestamp, row-major 3x4 gwc, features, and the
    2-dof gravity-alignment rotation wg (vlslam.proto:26-31)."""

    ts: float = 0.0
    gwc: np.ndarray = field(default_factory=lambda: np.zeros(12))
    features: List[Feature] = field(default_factory=list)
    wg: np.ndarray = field(default_factory=lambda: np.zeros(2))

    def encode(self) -> bytes:
        buf = bytearray()
        wire.write_double(buf, 1, self.ts)
        for v in np.asarray(self.gwc, dtype=np.float64).ravel():
            wire.write_double(buf, 2, v)
        for feat in self.features:
            wire.write_bytes(buf, 3, feat.encode())
        for v in np.asarray(self.wg, dtype=np.float64).ravel():
            wire.write_double(buf, 4, v)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Packet":
        f = wire.parse_fields(data)
        return cls(
            ts=float(wire.as_doubles(f.get(1, [0.0]))[0]),
            gwc=wire.as_doubles(f.get(2, [])),
            features=[Feature.decode(b) for b in f.get(3, [])],
            wg=wire.as_doubles(f.get(4, [])),
        )


@dataclass
class Track:
    ts: float = 0.0
    tracklets: List[Feature] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        wire.write_double(buf, 1, self.ts)
        for feat in self.tracklets:
            wire.write_bytes(buf, 2, feat.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Track":
        f = wire.parse_fields(data)
        return cls(
            ts=float(wire.as_doubles(f.get(1, [0.0]))[0]),
            tracklets=[Feature.decode(b) for b in f.get(2, [])],
        )


@dataclass
class Dataset:
    description: str = ""
    camera: CameraInfo = field(default_factory=CameraInfo)
    packets: List[Packet] = field(default_factory=list)
    tracks: List[Track] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.description:
            wire.write_string(buf, 1, self.description)
        wire.write_bytes(buf, 2, self.camera.encode())
        for p in self.packets:
            wire.write_bytes(buf, 3, p.encode())
        for t in self.tracks:
            wire.write_bytes(buf, 4, t.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Dataset":
        f = wire.parse_fields(data)
        desc = f.get(1, [b""])[0].decode("utf-8") if f.get(1) else ""
        cam = CameraInfo.decode(f[2][0]) if f.get(2) else CameraInfo()
        return cls(
            description=desc,
            camera=cam,
            packets=[Packet.decode(b) for b in f.get(3, [])],
            tracks=[Track.decode(b) for b in f.get(4, [])],
        )


@dataclass
class EdgeMap:
    description: str = ""
    rows: int = 0
    cols: int = 0
    data: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def encode(self) -> bytes:
        buf = bytearray()
        if self.description:
            wire.write_string(buf, 1, self.description)
        wire.write_int(buf, 2, self.rows)
        wire.write_int(buf, 3, self.cols)
        for v in np.asarray(self.data, dtype=np.float32).ravel():
            wire.write_float(buf, 4, float(v))
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "EdgeMap":
        f = wire.parse_fields(data)
        desc = f.get(1, [b""])[0].decode("utf-8") if f.get(1) else ""
        return cls(
            description=desc,
            rows=wire.to_signed(wire.as_ints(f.get(2, [0]))[0]),
            cols=wire.to_signed(wire.as_ints(f.get(3, [0]))[0]),
            data=wire.as_floats(f.get(4, [])),
        )

    def as_image(self) -> np.ndarray:
        """(rows, cols) float32 map."""
        return np.asarray(self.data, np.float32).reshape(self.rows, self.cols)


@dataclass
class BoundingBox:
    top_left_x: float = 0.0
    top_left_y: float = 0.0
    bottom_right_x: float = 0.0
    bottom_right_y: float = 0.0
    scores: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    class_name: str = ""
    label: int = 0
    azimuth: Optional[float] = None
    shape_id: str = ""
    azimuth_prob: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def encode(self) -> bytes:
        buf = bytearray()
        wire.write_float(buf, 1, self.top_left_x)
        wire.write_float(buf, 2, self.top_left_y)
        wire.write_float(buf, 3, self.bottom_right_x)
        wire.write_float(buf, 4, self.bottom_right_y)
        for s in np.asarray(self.scores, np.float32).ravel():
            wire.write_float(buf, 5, float(s))
        if self.class_name:
            wire.write_string(buf, 6, self.class_name)
        if self.label:
            wire.write_int(buf, 7, self.label)
        if self.azimuth is not None:
            wire.write_float(buf, 8, self.azimuth)
        if self.shape_id:
            wire.write_string(buf, 9, self.shape_id)
        for s in np.asarray(self.azimuth_prob, np.float32).ravel():
            wire.write_float(buf, 10, float(s))
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "BoundingBox":
        f = wire.parse_fields(data)

        def f32(n, default=0.0):
            v = wire.as_floats(f.get(n, []))
            return float(v[0]) if v.size else default

        return cls(
            top_left_x=f32(1),
            top_left_y=f32(2),
            bottom_right_x=f32(3),
            bottom_right_y=f32(4),
            scores=wire.as_floats(f.get(5, [])),
            class_name=f.get(6, [b""])[0].decode("utf-8") if f.get(6) else "",
            label=wire.to_signed(wire.as_ints(f.get(7, [0]))[0]),
            azimuth=f32(8) if f.get(8) else None,
            shape_id=f.get(9, [b""])[0].decode("utf-8") if f.get(9) else "",
            azimuth_prob=wire.as_floats(f.get(10, [])),
        )


@dataclass
class BoundingBoxList:
    description: str = ""
    bounding_boxes: List[BoundingBox] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.description:
            wire.write_string(buf, 1, self.description)
        for b in self.bounding_boxes:
            wire.write_bytes(buf, 2, b.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "BoundingBoxList":
        f = wire.parse_fields(data)
        desc = f.get(1, [b""])[0].decode("utf-8") if f.get(1) else ""
        return cls(
            description=desc,
            bounding_boxes=[BoundingBox.decode(b) for b in f.get(2, [])],
        )
