from .bicycle import (VehicleState, clip_action, step, substep_closed_form, substep_euler,
                      substep_trajectory)

__all__ = ["VehicleState", "clip_action", "step", "substep_closed_form", "substep_euler",
           "substep_trajectory"]
