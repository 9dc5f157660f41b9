"""vlslam wire-format data model: the port's own numpy copy of the
reference's `proto` package (protocols/vlslam.proto parity), without the
generated `vlslam_pb2` module. Imports neither torch nor jax."""

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
