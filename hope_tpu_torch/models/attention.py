"""ViT-style encoder over modality tokens
(counterpart of ``hope_tpu/models/attention.py``): pre-norm multi-head
attention + tanh feed-forward with residuals, then flatten + 2-layer head."""
from __future__ import annotations

import torch
from torch import nn

# Flax LayerNorm's epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in (q, k, v))
        attn = torch.einsum("bhid,bhjd->bhij", q, k) * (self.dim_head ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, heads, dim_head)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, mlp_dim)

    def forward(self, x):
        x = self.attn(self.ln1(x)) + x
        return self.ff(self.ln2(x)) + x


class AttentionFusion(nn.Module):
    """Encoder over modality tokens -> flatten -> 2-layer head."""

    def __init__(self, dim: int, n_tokens: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(dim, heads, dim_head, mlp_dim)
                                    for _ in range(depth))
        self.fc1 = nn.Linear(dim * n_tokens, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)

    def forward(self, tokens):
        x = tokens
        for layer in self.layers:
            x = layer(x)
        return self.fc2(torch.tanh(self.fc1(x.reshape(x.shape[0], -1))))
