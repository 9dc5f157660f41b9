"""MSCKF visual-inertial filter (port of visma_tpu/filter; see the reference
package docstring for the feature lifecycle), with in-state SLAM landmarks
(`slam.py`, `FilterConfig.num_slam`). `feed.pack_frames` packs a vlslam
Dataset + IMU stream for `Msckf.run`."""

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.state import (FilterState, TrackTable, init_state,
                                          stack_states)
from visma_tpu_torch.filter.msckf import Msckf

__all__ = ["FilterConfig", "FilterState", "TrackTable", "init_state",
           "stack_states", "Msckf"]
