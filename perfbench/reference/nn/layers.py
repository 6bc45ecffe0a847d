"""The flax.linen basics the port needs, as PyTorch modules over [..., C].

Each module that holds parameters knows how to take them from the flax
tree (``from_flax_leaves``: flax leaf dict -> this module's state-dict
entries), so ``perfbench.reference.weights.from_flax`` can walk any model
mechanically. Norms use flax's eps of 1e-6, not torch's 1e-5.

Dtypes follow flax, so that a module whose parameters were cast to
bfloat16 computes what the reference computes with a bfloat16 tree:
``promote_dtype`` casts a layer's input and its own parameters to JAX's
promoted dtype (bfloat16 with float32 gives float32) before the product
(torch raises on mixed operands where JAX promotes, so the cast sits in
the layer, never at the call site); the norms take their statistics and
apply their scale and bias in float32 and return the promoted dtype.
In a 16-bit dtype XLA rounds every step of an op to that dtype: a
layer's product and then its bias sum (torch's fused bias rounds once),
and each step of ``silu`` and ``softmax`` below. Those steps are taken
one by one there; float32 keeps the fused calls.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


def result_dtype(*args) -> torch.dtype:
    """The dtype JAX promotes the float tensors ``args`` (None skipped)
    to: for the float types torch's promotion of tensors with dimensions
    is JAX's (bfloat16 with float16 or float32 gives float32)."""
    return functools.reduce(torch.promote_types,
                            [a.dtype for a in args if a is not None])


def promote_dtype(*args):
    """flax's ``promote_dtype``: ``args`` (None kept) cast to
    ``result_dtype(*args)``."""
    dt = result_dtype(*args)
    return [None if a is None else a.to(dt) for a in args]


def is_16bit(x: torch.Tensor) -> bool:
    """bfloat16 or float16: where XLA rounds each step of an op."""
    return x.dtype in (torch.bfloat16, torch.float16)


def add_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """flax's ``y += bias`` after a product, rounded on its own."""
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as JAX computes it: mixed operands promote."""
    return torch.matmul(*promote_dtype(a, b))


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's normalization statistics: float32 at least."""
    return torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Linear):
    """flax ``nn.Dense``: kernel [in, out] <-> torch weight [out, in].
    ``zero_init`` marks a kernel that a fresh init sets to zero
    (``nn.init.fresh_init_``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, zero_init: bool = False):
        super().__init__(in_features, out_features, bias)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote_dtype(x, self.weight, self.bias)
        if is_16bit(x):      # then flax's bias sum rounds on its own
            return add_bias(F.linear(x, w), b)
        return F.linear(x, w, b)

    def from_flax_leaves(self, leaves):
        out = {"weight": np.asarray(leaves["kernel"]).T}
        if "bias" in leaves:
            out["bias"] = leaves["bias"]
        return out

    def to_flax_leaves(self, state):
        out = {"kernel": state["weight"].T}
        if "bias" in state:
            out["bias"] = state["bias"]
        return out


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` (eps 1e-6, scale/bias) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _stats_dtype(x)
        y = F.layer_norm(x.to(dt), self.normalized_shape,
                         self.weight.to(dt), self.bias.to(dt), self.eps)
        return y.to(result_dtype(x, self.weight, self.bias))

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["scale"], "bias": leaves["bias"]}

    def to_flax_leaves(self, state):
        return {"scale": state["weight"], "bias": state["bias"]}


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over channels-last [B, T, C]: statistics per
    (batch, group) over time and the group's channels, eps 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        dt = _stats_dtype(x)
        g = x.to(dt).reshape(B, T, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        y = g.reshape(B, T, C) * self.weight.to(dt) + self.bias.to(dt)
        return y.to(result_dtype(x, self.weight, self.bias))

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["scale"], "bias": leaves["bias"]}

    def to_flax_leaves(self, state):
        return {"scale": state["weight"], "bias": state["bias"]}


class Embed(nn.Embedding):
    """flax ``nn.Embed`` (table under ``embedding``): rows in the
    table's own dtype."""

    def from_flax_leaves(self, leaves):
        return {"weight": leaves["embedding"]}

    def to_flax_leaves(self, state):
        return {"embedding": state["weight"]}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), which XLA expands to
    x * (1 / (1 + exp(-x))), each step rounded in a 16-bit dtype."""
    if is_16bit(x):
        return x * (1.0 / (1.0 + torch.exp(-x)))
    return F.silu(x)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max) / sum, each step rounded in a
    16-bit dtype (the sum accumulates in float32, as ``jnp.sum`` does)."""
    if is_16bit(x):
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        return e / e.sum(dim=dim, keepdim=True)
    return torch.softmax(x, dim=dim)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` defaults to the tanh approximation."""
    return F.gelu(x, approximate="tanh")
