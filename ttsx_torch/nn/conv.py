"""1-D convolutions over the canonical [B, T, C] layout (``ttsx/nn/conv.py``).

``Conv1d`` pads as XLA does: SAME splits ``max((ceil(T/s)-1)*s + (k-1)*d
+ 1 - T, 0)`` rows with the smaller half first (so stride 2 on an even T
pads only at the end), CAUSAL pads (k-1)*d rows in front, VALID none.
torch's ``padding="same"`` rejects stride > 1, so the pad is explicit.

``ConvTranspose1d`` keeps torch's weight layout [Cin, Cout, k]; flax's
[k, Cin, Cout] kernel arrives reversed along k (settled by
tests/test_torch_nn.py). Its forward runs the tap-bank form of
``ops.upsample.convt_taps`` (k = 2*stride, cropped to T*stride).

Both compute in the promoted dtype of the input and their parameters,
as flax's ``nn.Conv`` and ``nn.ConvTranspose`` do.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ttsx_torch.nn.layers import add_bias, is_16bit, promote_dtype
from ttsx_torch.ops.upsample import convt_taps


def same_pads(t: int, k: int, stride: int = 1, dilation: int = 1):
    out = -(-t // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - t, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """SAME/CAUSAL/VALID conv; weight [Cout, Cin/groups, k]. ``zero_init``
    marks a kernel that a fresh init sets to zero (``nn.init.fresh_init_``)."""
    flax_inner = "Conv_0"

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: str = "SAME", use_bias: bool = True,
                 zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.kernel_size, self.stride = kernel_size, stride
        self.dilation, self.groups, self.padding = dilation, groups, padding
        self.weight = nn.Parameter(
            torch.empty(features, in_channels // groups, kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def pads(self, t: int):
        if self.padding == "SAME":
            return same_pads(t, self.kernel_size, self.stride, self.dilation)
        if self.padding == "CAUSAL":
            return (self.kernel_size - 1) * self.dilation, 0
        if self.padding == "VALID":
            return 0, 0
        raise ValueError(f"padding {self.padding!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.pads(x.shape[1])
        x, w, b = promote_dtype(x, self.weight, self.bias)
        h = F.pad(x.transpose(1, 2), (lo, hi))
        split = is_16bit(x)      # then flax's bias sum rounds on its own
        y = F.conv1d(h, w, None if split else b, self.stride,
                     dilation=self.dilation, groups=self.groups)
        y = y.transpose(1, 2)
        return add_bias(y, b) if split else y

    def from_flax_leaves(self, leaves):
        out = {"weight": np.asarray(leaves["kernel"]).transpose(2, 1, 0)}
        if "bias" in leaves:
            out["bias"] = leaves["bias"]
        return out


class ConvTranspose1d(nn.Module):
    """Strided transposed conv with T_out = T * stride (k = 2*stride,
    torch-style crop of stride // 2 rows); weight [Cin, Cout, k]."""
    flax_inner = "ConvTranspose_0"

    def __init__(self, in_channels: int, features: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, 2 * stride))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def tap_weight(self) -> torch.Tensor:
        """The kernel as [k, Cin, Cout] taps, as ops.upsample takes it."""
        return self.weight.flip(-1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return convt_taps(*promote_dtype(x, self.tap_weight(), self.bias),
                          self.stride)

    def from_flax_leaves(self, leaves):
        k = np.asarray(leaves["kernel"])           # [k, Cin, Cout]
        return {"weight": k[::-1].transpose(1, 2, 0).copy(),
                "bias": leaves["bias"]}
