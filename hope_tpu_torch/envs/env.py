"""Batched parking environment (counterpart of ``hope_tpu/envs/env.py``).

Every method works on a whole batch of B scenarios at once: the JAX
package's single-env functions under ``vmap`` become tensors with a leading
batch dim. The single-env entry points (``reset``, ``step``, ``observe``)
are the batched path at B = 1. The three CUDA kernels run on every control step: the action
mask (``ops.mask_step_lengths``), the BEV image (``ops.raster_bev``) and the
RS endgame sweep (``ops.swept_collide``, through ``planning.rs_select``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import EnvConfig
from ..device import resolve_device
from ..dynamics import VehicleState, substep_trajectory
from ..geometry import (
    box_to_edges,
    convex_clip_area,
    polygon_area,
    pose_to_box,
    segments_intersect,
)
from ..ops.raster_bev import render_bev_batch
from ..planning import RSPath, find_path, find_path_batch
from ..utils.profiling import annotate, annotated, count
from ..utils.tree import tree_map
from .action_mask import ActionMaskTable, build_table, get_steps
from .lidar import beam_angles, lidar_observation, vehicle_boundary
from .rewards import ARRIVED, COLLIDED, CONTINUE, OUTBOUND, OUTTIME, shaped_reward, step_reward_terms
from .scene import Scene


@dataclass
class EnvState:
    vehicle: VehicleState
    t: torch.Tensor              # (B,) int32 step counter (1 after reset)
    accum_arrive: torch.Tensor   # (B,) monotonic box-union accumulator
    status: torch.Tensor         # (B,) int32 status code
    scene: Scene


def select(cond, a, b):
    """Per-env select over a dataclass tree: ``a`` where ``cond`` (B,) holds,
    else ``b``."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)
    if isinstance(a, dict):
        return {k: select(cond, a[k], b[k]) for k in a}
    return type(a)(**{f.name: select(cond, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


class ParkingEnv:
    """Static config + precomputed tables on one device; batched methods."""

    def __init__(self, cfg: EnvConfig = EnvConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.corners = torch.as_tensor(cfg.vehicle.box_corners(), dtype=torch.float32,
                                       device=dev)
        self.angles = beam_angles(cfg.lidar, dev)
        self.hull_base = vehicle_boundary(cfg.lidar, cfg.vehicle, dev)
        self.mask_table: ActionMaskTable = build_table(cfg.mask, cfg.lidar, cfg.vehicle, dev)
        self._scale = torch.tensor([cfg.vehicle.max_steer, cfg.vehicle.max_speed],
                                   dtype=torch.float32, device=dev)

    # ------------------------------------------------------------------ obs

    def _target_repr(self, pose, dest):
        """(B, 5) target representation (reference _get_targt_repr),
        reproducing the duplicated-cos bug by default."""
        dx = dest[:, 0] - pose[:, 0]
        dy = dest[:, 1] - pose[:, 1]
        rel_dist = torch.hypot(dx, dy)
        rel_angle = torch.atan2(dy, dx) - pose[:, 2]
        rel_heading = dest[:, 2] - pose[:, 2]
        fifth = (torch.cos(rel_heading) if self.cfg.obs.reproduce_target_repr_bug
                 else torch.sin(rel_heading))
        return torch.stack([rel_dist, torch.cos(rel_angle), torch.sin(rel_angle),
                            torch.cos(rel_heading), fifth], dim=-1)

    @annotated("env/observe")
    def observe_batch(self, state: EnvState) -> dict:
        """Observation dict for the batch: lidar (B, R), action_mask (B, A),
        img (B, 3, H, W), target (B, 5), as enabled in ``cfg.obs``."""
        cfg = self.cfg
        pose = state.vehicle.pose
        scene = state.scene
        obs = {}
        with annotate("env/lidar"):
            lidar = lidar_observation(pose, scene.edges, scene.edge_mask, self.angles,
                                      self.hull_base, cfg.lidar)
        if cfg.obs.use_lidar:
            obs["lidar"] = lidar
        if cfg.obs.use_action_mask:
            obs["action_mask"] = get_steps(lidar, self.mask_table, cfg.mask, cfg.lidar)
        if cfg.obs.use_img:
            vbox = pose_to_box(pose, self.corners)
            obs["img"] = render_bev_batch(
                pose, vbox, scene.dest_box, scene.edges, scene.edge_mask,
                scene.edge_poly, cfg.obs, cfg.vehicle).permute(0, 3, 1, 2)
        obs["target"] = self._target_repr(pose, scene.dest)
        return obs

    # ----------------------------------------------------------------- reset

    @staticmethod
    def _init_state(scenes: Scene) -> EnvState:
        """Fresh states for a batch of scenes, as after the reference's
        no-action step (t = 1)."""
        B = scenes.start.shape[0]
        dev = scenes.start.device
        return EnvState(
            vehicle=VehicleState.from_pose(scenes.start),
            t=torch.ones(B, dtype=torch.int32, device=dev),
            accum_arrive=torch.zeros(B, device=dev),
            status=torch.full((B,), CONTINUE, dtype=torch.int32, device=dev),
            scene=scenes,
        )

    def observe(self, state: EnvState) -> dict:
        """Observation dict of one env (a state of unbatched fields)."""
        obs = self.observe_batch(tree_map(lambda x: x[None], state))
        return {k: v[0] for k, v in obs.items()}

    def reset(self, scene: Scene):
        """Fresh state of one scenario (unbatched fields) and its
        observation, as after the reference's no-action step (t = 1)."""
        state = tree_map(lambda x: x[0], self._init_state(tree_map(lambda x: x[None], scene)))
        return state, self.observe(state)

    def step(self, state: EnvState, action, search_rs: bool = True):
        """One control step of one env with a physical (2,) [steer, speed]
        action. Returns (state, obs, reward, done, info) as
        :meth:`batch_step`, unbatched; the RS search is the JAX package's
        single-env one (``find_path`` at its default 6 words)."""
        new_state, reward, done, info = self._transition(tree_map(lambda x: x[None], state),
                                                         action[None])
        new_state, reward, done, info = tree_map(lambda x: x[0], (new_state, reward, done, info))
        if search_rs:
            cfg = self.cfg
            scene = new_state.scene
            pose = new_state.vehicle.pose
            near = torch.hypot(pose[0] - scene.dest[0], pose[1] - scene.dest[1]) < cfg.rs_max_dist
            want = (new_state.t > 1) & (new_state.status == CONTINUE) & near
            rs = find_path(pose, scene.dest, cfg.vehicle.max_curvature, self.corners, scene.edges,
                           scene.edge_mask, scene.bounds, n_points=cfg.rs_max_points,
                           step_m=cfg.rs_step_size)
            info["rs"] = RSPath(found=rs.found & want, lengths=rs.lengths, steers=rs.steers,
                                L=rs.L)
        return new_state, self.observe(new_state), reward, done, info

    @annotated("env/reset")
    def batch_reset(self, scenes: Scene):
        """Fresh states for a batch of scenes and their observations."""
        state = self._init_state(scenes)
        return state, self.observe_batch(state)

    @staticmethod
    def reset_where(state: EnvState, fresh: EnvState, done) -> EnvState:
        """Lockstep auto-reset: where ``done`` (B,), adopt the fresh per-env
        state, scene included."""
        return select(done, fresh, state)

    # ------------------------------------------------------------------ step

    @annotated("env/transition")
    def _transition(self, state: EnvState, action):
        """One control step minus observation: dynamics, termination, reward.

        All sub-step poses are the same closed-form arc at k*dt, so the
        reference's sequential accept/rollback loop becomes one evaluation
        plus a first-event selection: freeze at the first sub-step k* with
        arrival or collision; arrival accepts pose k*, collision rolls back to
        pose k*-1 (the pre-step state when k* is the first).
        """
        cfg = self.cfg
        scene = state.scene
        prev_pose = state.vehicle.pose
        B = prev_pose.shape[0]
        rows = torch.arange(B, device=prev_pose.device)

        n = cfg.vehicle.n_substep
        traj = substep_trajectory(state.vehicle, action, cfg.vehicle, n)   # (B, n)
        boxes = pose_to_box(traj.pose, self.corners)                       # (B, n, 4, 2)
        inter = convex_clip_area(boxes, scene.dest_box[:, None])
        arr = inter / polygon_area(scene.dest_box)[:, None] > cfg.arrive_overlap
        hits = segments_intersect(box_to_edges(boxes).reshape(B, n * 4, 4), scene.edges)
        col = torch.any((hits & scene.edge_mask[:, None, :]).reshape(B, n, -1), dim=-1)

        event = arr | col
        has_event = torch.any(event, dim=1)
        f0 = torch.argmax(event.to(torch.uint8), dim=1)                    # first event
        arr_f0 = arr[rows, f0]
        arrived = has_event & arr_f0
        coll_first = col[:, 0] & ~arr[:, 0]
        final_idx = torch.where(~has_event, n - 1, torch.where(arr_f0, f0, f0 - 1))
        take = final_idx >= 0
        fi = torch.clamp(final_idx, min=0)
        vehicle = VehicleState(*(torch.where(take, getattr(traj, f)[rows, fi],
                                             getattr(state.vehicle, f))
                                 for f in ("x", "y", "heading", "speed", "steer")))

        t = state.t + 1
        pose = vehicle.pose
        vbox = pose_to_box(pose, self.corners)
        b = scene.bounds
        outbound = ((pose[:, 0] < b[:, 0]) | (pose[:, 0] > b[:, 1])
                    | (pose[:, 1] < b[:, 2]) | (pose[:, 1] > b[:, 3]))
        status = torch.where(t > cfg.tolerant_time, OUTTIME, CONTINUE)
        status = torch.where(outbound, OUTBOUND, status)
        if cfg.env_collide:
            status = torch.where(coll_first, COLLIDED, status)
        status = torch.where(arrived, ARRIVED, status).to(torch.int32)

        terms, accum = step_reward_terms(
            prev_pose, pose, t.to(torch.float32), vbox, scene.dest, scene.start,
            scene.dest_box, state.accum_arrive, cfg)
        cont = status == CONTINUE
        terms = torch.where(cont[:, None], terms, 0.0)
        accum = torch.where(cont, accum, state.accum_arrive)

        new_state = EnvState(vehicle=vehicle, t=t, accum_arrive=accum, status=status,
                             scene=scene)
        reward = shaped_reward(terms, status, cfg)
        info = {"status": status, "reward_terms": terms}
        return new_state, reward, status != CONTINUE, info

    def rescale_action(self, model_action):
        """Model output [-1, 1]^2 -> physical [steer, speed]."""
        return torch.clamp(model_action, -1.0, 1.0) * self._scale

    @annotated("env/step")
    def batch_step(self, state: EnvState, actions, search_rs: bool = True):
        """One control step for the batch with physical (B, 2) actions.

        Returns (state, obs, reward, done, info); info carries the status, the
        raw reward terms and (when ``search_rs``) the RS path found this step.
        """
        new_state, reward, done, info = self._transition(state, actions)
        if search_rs:
            info["rs"] = self._batch_rs(new_state)
        return new_state, self.observe_batch(new_state), reward, done, info

    @annotated("env/rs_search")
    def _batch_rs(self, state: EnvState) -> RSPath:
        """RS endgame search for the envs that are running, past their first
        step and within ``rs_max_dist`` of the destination."""
        cfg = self.cfg
        scene = state.scene
        pose = state.vehicle.pose
        near = torch.hypot(pose[:, 0] - scene.dest[:, 0],
                           pose[:, 1] - scene.dest[:, 1]) < cfg.rs_max_dist
        want = (state.t > 1) & (state.status == CONTINUE) & near
        count("env/rs_rows_searched", pose.shape[0])
        count("env/rs_rows_wanted", want)
        rs = find_path_batch(pose, scene.dest, cfg.vehicle.max_curvature, self.corners,
                             scene.edges, scene.edge_mask, scene.bounds,
                             n_points=cfg.rs_max_points, step_m=cfg.rs_step_size,
                             max_tries=cfg.rs_max_tries)
        return RSPath(found=rs.found & want, lengths=rs.lengths, steers=rs.steers, L=rs.L)

    @property
    def observation_shape(self) -> dict:
        """Per-env shape of each observation key, as ``observe_batch`` gives
        them."""
        cfg = self.cfg
        shape = {}
        if cfg.obs.use_lidar:
            shape["lidar"] = (cfg.lidar.n_beams,)
        if cfg.obs.use_action_mask:
            shape["action_mask"] = (cfg.mask.n_actions,)
        if cfg.obs.use_img:
            shape["img"] = (3, cfg.obs.img_size, cfg.obs.img_size)
        shape["target"] = (cfg.obs.target_dim,)
        return shape
