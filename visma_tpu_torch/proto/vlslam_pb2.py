"""Drop-in `vlslam_pb2` shim for downstream ML pipelines (the port's copy
of visma_tpu/proto/vlslam_pb2.py, numpy only).

The reference installs protoc-generated Python bindings
(install.sh:18-21: `protoc protocols/vlslam.proto --python_out=scripts`)
which its scripts consume as `vlslam_pb2.Dataset()` +
`ParseFromString(...)` + plain attribute access
(scripts/example_load.py:29-51, scripts/utils.py:4-9). This module is not
generated: it reproduces that message surface by hand on top of the port's
own wire codec (visma_tpu_torch/proto/vlslam.py), byte-compatible with the
reference schema (pinned by tests/data/golden_seq) and requiring no
protobuf runtime.

Supported surface (what the reference's downstream code uses):
  - construction: `m = vlslam_pb2.Dataset()`
  - `m.ParseFromString(data)` / `m.SerializeToString()` / a deep
    `m.CopyFrom(other)`
  - attribute access with the schema's field names; repeated scalar
    fields are numpy arrays, repeated message fields are Python lists
  - enum constants: `vlslam_pb2.Feature.INSTATE` etc., plus the
    module-level `FeatureStatus`

Import it as `from visma_tpu_torch.proto import vlslam_pb2`; the package's
`__init__` does not import it.
"""
from __future__ import annotations

from visma_tpu_torch.proto import vlslam as _v

FeatureStatus = _v.FeatureStatus


def _shim(name: str, inner_cls, enum_attrs=None):
    """Build a pb2-style message class wrapping an internal codec class."""

    class Msg:
        __slots__ = ("_m",)

        def __init__(self, **kwargs):
            object.__setattr__(self, "_m", inner_cls(**kwargs))

        # -- protobuf message API ----------------------------------------
        def ParseFromString(self, data: bytes) -> int:
            object.__setattr__(self, "_m", inner_cls.decode(data))
            return len(data)

        def SerializeToString(self) -> bytes:
            return self._m.encode()

        def CopyFrom(self, other) -> None:
            # deep copy (protobuf CopyFrom semantics): re-decode through
            # the wire so later mutation of either message stays private
            src = object.__getattribute__(other, "_m")
            object.__setattr__(self, "_m", type(src).decode(src.encode()))

        # -- field access -------------------------------------------------
        def __getattr__(self, attr):
            return getattr(object.__getattribute__(self, "_m"), attr)

        def __setattr__(self, attr, value):
            setattr(self._m, attr, value)

        def __repr__(self):
            return repr(self._m)

    Msg.__name__ = Msg.__qualname__ = name
    for k, v in (enum_attrs or {}).items():
        setattr(Msg, k, v)
    return Msg


CameraInfo = _shim("CameraInfo", _v.CameraInfo)
Feature = _shim("Feature", _v.Feature,
                {s.name: int(s) for s in _v.FeatureStatus})
Packet = _shim("Packet", _v.Packet)
Track = _shim("Track", _v.Track)
Dataset = _shim("Dataset", _v.Dataset)
EdgeMap = _shim("EdgeMap", _v.EdgeMap)
BoundingBox = _shim("BoundingBox", _v.BoundingBox)
BoundingBoxList = _shim("BoundingBoxList", _v.BoundingBoxList)
