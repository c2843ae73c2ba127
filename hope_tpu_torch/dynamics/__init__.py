from .bicycle import VehicleState, clip_action, substep_trajectory

__all__ = ["VehicleState", "clip_action", "substep_trajectory"]
