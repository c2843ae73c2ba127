"""Typed configuration tree of the PyTorch port.

The same dataclasses, fields and defaults as ``hope_tpu/config.py`` (the port
keeps its own copy so that it never imports the JAX package), so a run's
config file reads identically in both packages.

The backend selectors of ``ObsConfig`` (``mask_backend``, ``raster_backend``)
and ``raster_edge_budget`` are kept for that compatibility only: the port
picks its kernels from the tensors' device, and always renders the full edge
set through ``ops.raster_bev``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class VehicleConfig:
    """Vehicle geometry + limits (reference ``configs.py:13-38``)."""

    wheel_base: float = 2.8
    front_hang: float = 0.96
    rear_hang: float = 0.93
    width: float = 1.94

    max_speed: float = 2.5          # VALID_SPEED
    max_steer: float = 0.75         # VALID_STEER
    n_substep: int = 10             # NUM_STEP  (sub-steps per control interval)
    dt: float = 5e-2                # STEP_LENGTH (seconds per sub-step)
    euler_iters: int = 20           # KSModel.mini_iter (reference vehicle.py:66)

    @property
    def length(self) -> float:
        return self.wheel_base + self.front_hang + self.rear_hang

    @property
    def min_turn_radius(self) -> float:
        return self.wheel_base / math.tan(self.max_steer)

    @property
    def max_curvature(self) -> float:
        # radius passed to the RS planner (reference car_parking_base.py:422)
        return math.tan(self.max_steer) / self.wheel_base

    def box_corners(self):
        """Vehicle footprint corners in the rear-axle frame, CCW starting rear-right.

        Order matches the reference ``VehicleBox`` LinearRing (configs.py:20-24):
        (rear-right, front-right, front-left, rear-left).
        """
        import numpy as np

        return np.array(
            [
                [-self.rear_hang, -self.width / 2],
                [self.front_hang + self.wheel_base, -self.width / 2],
                [self.front_hang + self.wheel_base, self.width / 2],
                [-self.rear_hang, self.width / 2],
            ]
        )


@dataclass(frozen=True)
class LidarConfig:
    """reference ``configs.py:95-96``."""

    n_beams: int = 120
    max_range: float = 10.0


@dataclass(frozen=True)
class ActionMaskConfig:
    """Discrete action set + mask table shape (reference ``configs.py:108-115``,
    ``model/action_mask.py``)."""

    precision: int = 10             # 2*precision+1 steer bins per direction
    n_iter: int = 10                # future substeps checked per action
    upsample: int = 10              # lidar-axis upsample rate
    step_speed: float = 1.0

    @property
    def n_actions(self) -> int:
        return 2 * (2 * self.precision + 1)  # 42


@dataclass(frozen=True)
class ObsConfig:
    """Observation layout (reference ``configs.py:89-106``)."""

    use_lidar: bool = True
    use_img: bool = True
    use_action_mask: bool = True
    img_size: int = 64              # OBS_W // downsample_rate
    img_res: float = 4.0 / 12.0     # metres per output pixel (downsample 4 / K=12 px/m)
    target_dim: int = 5
    max_dist_to_dest: float = 20.0
    # reference car_parking_base.py:380 duplicates cos(rel_dest_heading) where sin was
    # intended; keep the bug by default for parity, flip to get the fixed 5th feature.
    reproduce_target_repr_bug: bool = True
    # JAX-package backend selector; read by the port for nothing (see the
    # module docstring)
    mask_backend: str = "auto"
    # BEV obstacle parity: "exact" = per-polygon crossing parity (correct even
    # for overlapping obstacles — the default); "global" = one even-odd count
    # over all edges, identical output for disjoint obstacles (all DLP scenes;
    # procedural scenes can overlap obstacles on ~1% of pixels).
    raster_parity: str = "exact"
    # JAX-package polygon prefilter budget (0 = off); the port renders the
    # full edge set and culls per edge, which is exact
    raster_edge_budget: int = 0
    # JAX-package backend selector; read by the port for nothing
    raster_backend: str = "auto"


@dataclass(frozen=True)
class RewardConfig:
    """reference ``configs.py:181-187`` + env_wrapper terminal rewards."""

    ratio: float = 0.1
    w_time: float = 1.0
    w_rs_dist: float = 0.0
    w_dist: float = 5.0
    w_angle: float = 0.0
    w_box_union: float = 10.0
    r_arrived: float = 50.0
    r_collided: float = -50.0
    r_outbound: float = -50.0
    r_outtime: float = -1.0


@dataclass(frozen=True)
class EnvConfig:
    vehicle: VehicleConfig = field(default_factory=VehicleConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    mask: ActionMaskConfig = field(default_factory=ActionMaskConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    reward: RewardConfig = field(default_factory=RewardConfig)

    tolerant_time: int = 200        # TOLERANT_TIME
    rs_max_dist: float = 10.0       # RS_MAX_DIST
    arrive_overlap: float = 0.95    # car_parking_base.py:168
    env_collide: bool = False       # ENV_COLLIDE (False => collisions freeze, not kill)
    max_edges: int = 256            # padded obstacle-edge budget per scene
    max_obstacles: int = 64         # padded polygon budget per scene (raster channel ids)

    # Reeds-Shepp
    rs_step_size: float = 0.1       # metres between discretized path points
    rs_max_points: int = 288        # fixed discretization budget per candidate path
    rs_max_tries: int = 6           # shortest candidate words collision-checked
    rs_queue_len: int = 32          # fixed action-queue budget for RS execution

    @property
    def step_ratio(self) -> float:
        """Metres travelled per control step at full speed (train_HOPE_sac.py:164)."""
        return self.vehicle.dt * self.vehicle.n_substep * self.vehicle.max_speed


# ---------------------------------------------------------------------------
# scenario generation (reference configs.py:42-75 map-level dicts)
# ---------------------------------------------------------------------------

_LENGTH = VehicleConfig().length
_WIDTH = VehicleConfig().width


@dataclass(frozen=True)
class ScenarioConfig:
    """Procedural scenario-generation parameters per difficulty level."""

    level: str = "Normal"           # Normal | Complex | Extrem
    min_lot_len: float = _LENGTH * 1.25
    max_lot_len: float = _LENGTH * 1.25 + 0.5
    min_lot_width: float = _WIDTH + 0.85
    max_lot_width: float = _WIDTH + 1.2
    para_wall_dist: float = 4.5
    bay_wall_dist: float = 7.0
    n_extra_obstacles: int = 3
    min_dist_to_obst: float = 0.1
    bay_half_len: float = 15.0
    para_half_len: float = 18.0
    prob_huge_obst: float = 0.5
    n_non_critical_car: int = 3
    prob_non_critical_car: float = 0.7
    gen_attempts: int = 8           # bounded rejection-resampling budget
    start_attempts: int = 16

    @staticmethod
    def for_level(level: str) -> "ScenarioConfig":
        L, W = _LENGTH, _WIDTH
        if level == "Normal":
            return ScenarioConfig(
                level="Normal",
                min_lot_len=L * 1.25, max_lot_len=L * 1.25 + 0.5,
                min_lot_width=W + 0.85, max_lot_width=W + 1.2,
                para_wall_dist=4.5, bay_wall_dist=7.0, n_extra_obstacles=3,
            )
        if level == "Complex":
            return ScenarioConfig(
                level="Complex",
                min_lot_len=L + 0.9, max_lot_len=L * 1.25,
                min_lot_width=W + 0.4, max_lot_width=W + 0.85,
                para_wall_dist=4.0, bay_wall_dist=6.0, n_extra_obstacles=5,
            )
        if level == "Extrem":
            return ScenarioConfig(
                level="Extrem",
                min_lot_len=L + 0.6, max_lot_len=L + 0.9,
                # Extrem has no bay-parking entries in the reference dicts: parallel only
                min_lot_width=W + 0.4, max_lot_width=W + 0.85,
                para_wall_dist=3.5, bay_wall_dist=6.0, n_extra_obstacles=8,
            )
        raise ValueError(f"unknown level {level!r}")


# ---------------------------------------------------------------------------
# model / RL configs (reference configs.py:119-197)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    depth: int = 1
    heads: int = 8
    dim_head: int = 32
    mlp_dim: int = 128
    hidden_dim: int = 128


@dataclass(frozen=True)
class NetConfig:
    """MultiObsEmbedding layout (reference ACTOR_CONFIGS / CRITIC_CONFIGS)."""

    lidar_dim: int = 120
    target_dim: int = 5
    action_mask_dim: Optional[int] = 42
    img_shape: Optional[Tuple[int, int, int]] = (3, 64, 64)
    action_input_dim: int = 0       # >0 for critics consuming the action as a modality
    output_dim: int = 2
    embed_dim: int = 128
    hidden_dim: int = 256
    n_hidden_layers: int = 3
    n_embed_layers: int = 2
    img_conv_channels: Tuple[int, ...] = (4, 8)
    img_fc_sizes: Tuple[int, ...] = (256,)
    img_conv_kernel: int = 3
    use_tanh_output: bool = True
    use_tanh_activation: bool = True
    attention: Optional[AttentionConfig] = field(default_factory=AttentionConfig)
    orthogonal_init: bool = True

    @property
    def n_modal(self) -> int:
        n = 2  # lidar + target
        if self.action_mask_dim:
            n += 1
        if self.img_shape is not None:
            n += 1
        if self.action_input_dim:
            n += 1
        return n


@dataclass(frozen=True)
class SACConfig:
    gamma: float = 0.98
    lr_actor: float = 5e-6
    lr_critic: float = 5e-6
    lr_alpha: float = 5e-6
    tau: float = 0.005
    memory_size: int = 10240
    batch_size: int = 32
    initial_temperature: float = 0.01
    action_dim: int = 2
    target_entropy: float = -2.0
    learn_temperature: bool = True
    state_norm: bool = True
    reward_norm: bool = False
    update_every: int = 10
    # lr schedule (reference agent_base.lr_decay :81-86): None, "linear", "exp"
    lr_decay: str | None = None
    max_train_steps: int = 1_000_000
    # epsilon-greedy exploration mix-in (reference agent_base.epsilon_greedy
    # :76-79 / env_wrapper.action_rescale :37-50); 0 disables
    explore_epsilon: float = 0.0
    # keep a grafted pretrained image encoder fixed during training
    # (reference load_img_encoder(..., require_grad=False) network.py:158-162)
    freeze_img_encoder: bool = False


@dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.98
    lr_actor: float = 5e-6
    lr_critic: float = 2.5e-5       # 5x actor lr (ppo_agent.py:22)
    tau: float = 0.1
    buffer_size: int = 8192
    mini_epoch: int = 10
    mini_batch: int = 32
    clip_epsilon: float = 0.2
    gae_lambda: float = 0.95
    adv_norm: bool = True
    use_gae: bool = True
    state_norm: bool = True
    policy_entropy: bool = False
    entropy_coef: float = 0.01
    gradient_clip: bool = False
    action_dim: int = 2
    # policy distribution family (reference ppo_agent.py:119-144):
    # "gaussian" (clamped mean + global log_std), "beta" (softplus+1 params,
    # actions scaled (0,1)->[-1,1]), or "categorical" (logits over the 42
    # discrete actions)
    dist_type: str = "gaussian"
    n_discrete: int = 42
    lr_decay: str | None = None      # None, "linear", "exp"
    max_train_steps: int = 1_000_000
    # KL early-stop guard (stabilizer beyond the reference, which has none and
    # collapses on long runs — see runlogs/ppo_r3.log): once the approximate
    # KL(old || new) of a minibatch exceeds this, the remaining minibatch
    # updates of the whole buffer pass become no-ops.  None disables.
    target_kl: float | None = None


def actor_net_config(obs: ObsConfig = ObsConfig()) -> NetConfig:
    return NetConfig(
        action_mask_dim=42 if obs.use_action_mask else None,
        img_shape=(3, obs.img_size, obs.img_size) if obs.use_img else None,
        output_dim=2,
        use_tanh_output=True,
    )


def critic_net_config(obs: ObsConfig = ObsConfig(), action_input: bool = False) -> NetConfig:
    return NetConfig(
        action_mask_dim=42 if obs.use_action_mask else None,
        img_shape=(3, obs.img_size, obs.img_size) if obs.use_img else None,
        action_input_dim=2 if action_input else 0,
        output_dim=1,
        use_tanh_output=False,
    )


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
