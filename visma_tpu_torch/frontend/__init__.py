"""Feature frontend for the VIO slice (port of visma_tpu/frontend along the
fused-LK path; the windowed tracker frontend/klt.py is not ported yet)."""

from visma_tpu_torch.frontend.detect import corner_score, detect_features
from visma_tpu_torch.frontend.klt_fused import lk_level, track_features_fused
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.frontend.tracker import FeatureTracker, TrackerState

__all__ = ["build_pyramid", "corner_score", "detect_features", "lk_level",
           "track_features_fused", "FeatureTracker", "TrackerState"]
