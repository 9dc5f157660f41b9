"""Feature lifecycle codes of the VISMA wire format (vlslam.proto:11-19),
as the filter's track table stores them. Part of the benchmark's plain
reference."""
import enum


class FeatureStatus(enum.IntEnum):
    EMPTY = 0
    GOODDROP = 1
    KEEP = 2
    REJECT = 3
    INITIALIZING = 4
    READY = 5
    INSTATE = 6
