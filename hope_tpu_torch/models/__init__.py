from .attention import AttentionFusion
from .policy import Critic, ImgEncoder, MultiObsEmbedding, ValueNet, flax_init_

__all__ = ["AttentionFusion", "Critic", "ImgEncoder", "MultiObsEmbedding", "ValueNet",
           "flax_init_"]
