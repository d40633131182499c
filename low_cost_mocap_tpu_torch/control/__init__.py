"""Native (C++) control runtime: drone cascade, simulator, SBUS, trajectory
planner and host ingest — the port's own copy (``control/native/``)."""

from low_cost_mocap_tpu_torch.control.bindings import (
    CascadeBank,
    DroneSimulator,
    plan_trajectory_segment,
    sbus_decode,
    sbus_encode,
)

__all__ = [
    "CascadeBank",
    "DroneSimulator",
    "plan_trajectory_segment",
    "sbus_encode",
    "sbus_decode",
]
