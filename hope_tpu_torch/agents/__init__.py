from .state_norm import NormState, normalize, update as norm_update
from .sac import ActorState, SACAgent
from .hybrid import HybridState, latch, act as hybrid_act

__all__ = [
    "NormState", "normalize", "norm_update", "ActorState", "SACAgent",
    "HybridState", "latch", "hybrid_act",
]
