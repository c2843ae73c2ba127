from .state_norm import NormState, normalize, update as norm_update
from .replay import (Replay, create as replay_create, push_batch, sample as replay_sample,
                     flatten_obs, unflatten_obs)
from .sac import ActorState, SACAgent, SACState
from .ppo import PPOActor, PPOAgent, PPOState
from .hybrid import HybridState, latch, act as hybrid_act, reset_done as hybrid_reset_done

__all__ = [
    "NormState", "normalize", "norm_update",
    "Replay", "replay_create", "push_batch", "replay_sample",
    "flatten_obs", "unflatten_obs",
    "ActorState", "SACAgent", "SACState",
    "PPOActor", "PPOAgent", "PPOState",
    "HybridState", "latch", "hybrid_act", "hybrid_reset_done",
]
