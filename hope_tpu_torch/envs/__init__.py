from .scene import Scene, LEVEL_NAMES, LEVEL_NORMAL, LEVEL_COMPLEX, LEVEL_EXTREM, LEVEL_DLP
from .env import EnvState, ParkingEnv
from .rewards import CONTINUE, ARRIVED, COLLIDED, OUTBOUND, OUTTIME
from .action_mask import ActionMaskTable, build_table, choose_action, get_steps, discrete_actions
from .lidar import beam_angles, vehicle_boundary, lidar_observation

__all__ = [
    "Scene", "EnvState", "ParkingEnv",
    "CONTINUE", "ARRIVED", "COLLIDED", "OUTBOUND", "OUTTIME",
    "ActionMaskTable", "build_table", "choose_action", "get_steps", "discrete_actions",
    "beam_angles", "vehicle_boundary", "lidar_observation",
    "LEVEL_NAMES", "LEVEL_NORMAL", "LEVEL_COMPLEX", "LEVEL_EXTREM", "LEVEL_DLP",
]
