from .attention import AttentionFusion
from .policy import ImgEncoder, MultiObsEmbedding

__all__ = ["AttentionFusion", "ImgEncoder", "MultiObsEmbedding"]
