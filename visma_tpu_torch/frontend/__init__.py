"""Feature frontend for the VIO slice (port of visma_tpu/frontend): fused LK
(kernel lk_track, one launch a tracked frame) by default, the windowed tracker of frontend/klt.py on
request."""

from visma_tpu_torch.frontend.detect import corner_score, detect_features
from visma_tpu_torch.frontend.klt import (track_features,
                                          track_features_gather)
from visma_tpu_torch.frontend.klt_fused import (lk_level, lk_track,
                                                track_features_fused)
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.frontend.tracker import FeatureTracker, TrackerState

__all__ = ["build_pyramid", "corner_score", "detect_features", "lk_level",
           "lk_track", "track_features", "track_features_fused",
           "track_features_gather",
           "FeatureTracker", "TrackerState"]
