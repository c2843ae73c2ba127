"""The published constants the reference works from: HOPE's vehicle, lidar,
action mask, observation and reward settings (jiamiya/HOPE
``src/configs.py``) and the DLP scene rules. Plain numbers, written down
once for the reference; nothing is read from the program."""
from __future__ import annotations

import math

_WB, _FH, _RH, _W = 2.8, 0.96, 0.93, 1.94

VEHICLE = {
    "wheel_base": _WB, "front_hang": _FH, "rear_hang": _RH, "width": _W,
    "max_speed": 2.5, "max_steer": 0.75,
    "n_substep": 10, "dt": 0.05, "euler_iters": 20,
    # rear-right, front-right, front-left, rear-left, in the rear-axle frame
    "corners": [[-_RH, -_W / 2], [_FH + _WB, -_W / 2], [_FH + _WB, _W / 2], [-_RH, _W / 2]],
    "max_curvature": math.tan(0.75) / _WB,
}

OBS = {"n_beams": 120, "max_range": 10.0, "img_size": 64, "img_res": 4.0 / 12.0}

MASK = {"precision": 10, "n_iter": 10, "upsample": 10, "step_speed": 1.0}

REWARD = {"ratio": 0.1, "w_time": 1.0, "w_dist": 5.0, "w_angle": 0.0, "w_box_union": 10.0,
          "r_arrived": 50.0, "r_collided": -50.0, "r_outbound": -50.0, "r_outtime": -1.0}

ENV = {"tolerant_time": 200, "rs_max_dist": 10.0, "arrive_overlap": 0.95,
       "env_collide": False, "rs_step": 0.1, "rs_points": 288, "rs_queue": 32,
       # metres a control step covers at full speed
       "step_ratio": 0.05 * 10 * 2.5}

# status codes
CONTINUE, ARRIVED, COLLIDED, OUTBOUND, OUTTIME = 0, 1, 2, 3, 4

# the DLP bank's resets: start jitter (m, m, rad), bounds margin (m), the
# runtime edge and polygon budgets
DLP = {"jitter": (0.05, 0.05, 0.02), "margin": 20.0, "max_edges": 512, "max_obstacles": 128}

