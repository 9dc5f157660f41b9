"""vlslam wire-format data model: the port's own numpy copy of the
reference's `proto` package (protocols/vlslam.proto parity). Its
`vlslam_pb2` is the reference's hand-written, numpy-only shim of the
protoc-generated message API, copied on this package's codec; import it as
`from visma_tpu_torch.proto import vlslam_pb2` (this module does not).
Imports neither torch nor jax."""

from visma_tpu_torch.proto.vlslam import (
    FeatureStatus,
    CameraInfo,
    Feature,
    Packet,
    Track,
    Dataset,
    EdgeMap,
    BoundingBox,
    BoundingBoxList,
)

__all__ = [
    "FeatureStatus", "CameraInfo", "Feature", "Packet", "Track",
    "Dataset", "EdgeMap", "BoundingBox", "BoundingBoxList",
]
