"""MSCKF visual-inertial filter (port of visma_tpu/filter; see the reference
package docstring for the feature lifecycle). `feed.pack_frames` packs
a vlslam Dataset + IMU stream for `Msckf.run`. SLAM landmarks
(`filter/slam.py`) are not ported yet."""

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.state import FilterState, TrackTable, init_state
from visma_tpu_torch.filter.msckf import Msckf

__all__ = ["FilterConfig", "FilterState", "TrackTable", "init_state", "Msckf"]
