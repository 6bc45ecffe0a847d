"""Attention blocks (``ttsx/nn/attention.py``).

``MHSA`` holds flax ``MultiHeadDotProductAttention``'s parameters as four
linear maps (``Dense``, so each promotes as flax's ``DenseGeneral``):
query/key/value kernels [D, H, D/H] become [H*D/H, D] torch weights, the
out kernel [H, D/H, D] becomes [D, H*D/H]. Scores use
explicit f32 matmuls, with the query scaled by 1/sqrt(D/H) as flax does.
In a training forward (``draws`` given) the attention weights take
flax's broadcast dropout: one [Tq, Tk] mask shared by batch and heads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from perfbench.reference.nn.draws import Draws, replicated
from perfbench.reference.nn.layers import Dense


class _HeadsIn(Dense):
    def __init__(self, dim: int, num_heads: int):
        super().__init__(dim, dim)
        self.num_heads = num_heads

    def from_flax_leaves(self, leaves):
        k = np.asarray(leaves["kernel"])              # [D, H, Dh]
        return {"weight": k.reshape(k.shape[0], -1).T,
                "bias": np.asarray(leaves["bias"]).reshape(-1)}

    def to_flax_leaves(self, state):
        w, H = state["weight"], self.num_heads
        return {"kernel": w.T.reshape(w.shape[1], H, -1),
                "bias": state["bias"].reshape(H, -1)}


class _HeadsOut(Dense):
    def __init__(self, dim: int, num_heads: int):
        super().__init__(dim, dim)
        self.num_heads = num_heads

    def from_flax_leaves(self, leaves):
        k = np.asarray(leaves["kernel"])              # [H, Dh, D]
        return {"weight": k.reshape(-1, k.shape[-1]).T,
                "bias": leaves["bias"]}

    def to_flax_leaves(self, state):
        w = state["weight"]
        return {"kernel": w.T.reshape(self.num_heads, -1, w.shape[0]),
                "bias": state["bias"]}


class MHSA(nn.Module):
    """Multi-head attention over [B, T, D]; keys and values from ``kv``."""
    flax_inner = "MultiHeadDotProductAttention_0"

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.query = _HeadsIn(dim, num_heads)
        self.key = _HeadsIn(dim, num_heads)
        self.value = _HeadsIn(dim, num_heads)
        self.out = _HeadsOut(dim, num_heads)

    def forward(self, q_in: torch.Tensor,
                kv_in: torch.Tensor | None = None,
                draws: Draws | None = None) -> torch.Tensor:
        kv_in = q_in if kv_in is None else kv_in
        B, Tq, D = q_in.shape
        H = self.num_heads
        heads = lambda t: t.reshape(B, t.shape[1], H, D // H).transpose(1, 2)
        q = heads(self.query(q_in)) / math.sqrt(D // H)
        k = heads(self.key(kv_in))
        v = heads(self.value(kv_in))
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        if draws is not None and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            # one mask for the whole batch, so the same on every rank
            keep = replicated(draws).bernoulli(
                keep_prob, (1, 1) + tuple(attn.shape[-2:]))
            attn = attn * (keep.float() / keep_prob)
        o = (attn @ v).transpose(1, 2).reshape(B, Tq, D)
        return self.out(o)


class SelfAttention1d(nn.Module):
    """Single-head attention on a strided subsample of T (stride
    ceil(T/max_attn_len)), repeated back and added with gain ``gamma``."""

    def __init__(self, channels: int, max_attn_len: int = 2048):
        super().__init__()
        self.max_attn_len = max_attn_len
        dq = channels // 4 if channels >= 8 else channels
        self.Dense_0 = Dense(channels, dq)
        self.Dense_1 = Dense(channels, dq)
        self.Dense_2 = Dense(channels, channels)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        stride = max(1, -(-T // self.max_attn_len))
        h = x[:, ::stride]
        q = self.Dense_0(h)
        k = self.Dense_1(h)
        v = self.Dense_2(h)
        scores = (q @ k.transpose(1, 2)) / math.sqrt(q.shape[-1])
        o = torch.softmax(scores, dim=-1) @ v
        if stride > 1:
            o = o.repeat_interleave(stride, dim=1)[:, :T]
        return x + self.gamma * o
