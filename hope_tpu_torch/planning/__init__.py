from . import reeds_shepp
from .rs_select import RSPath, build_action_queue, find_path_batch, traj_collides

__all__ = ["reeds_shepp", "RSPath", "find_path_batch", "build_action_queue",
           "traj_collides"]
