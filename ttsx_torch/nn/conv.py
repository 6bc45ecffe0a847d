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

For the vocoder's discriminators: ``SNConv``, a 1-D or 2-D conv whose
kernel is divided by its largest singular value (``spectral_normalize``:
8 power iterations from a cold start on every call, as the reference's,
never torch's warm-started ``spectral_norm``), SAME padding with any
strides; and ``avg_pool1d``, flax's SAME average pool, which counts the
padded zeros. An ``SNConv`` whose shape fits ``ops.conv1d_same`` (1-D,
stride 1, odd k, at least 64 channels in and out, multiples of 4) runs
its forward and input gradient on that kernel for float32 CUDA tensors;
every other ``SNConv``, and every one on the CPU, runs ``F.pad`` +
``F.conv1d``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ttsx_torch.nn.layers import add_bias, is_16bit, promote_dtype
from ttsx_torch.ops.conv1d_same import conv1d_same
from ttsx_torch.ops.upsample import convt_taps
from ttsx_torch.utils.spans import count, span


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

    def to_flax_leaves(self, state):
        out = {"kernel": state["weight"].transpose(2, 1, 0)}
        if "bias" in state:
            out["bias"] = state["bias"]
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

    def to_flax_leaves(self, state):
        return {"kernel": state["weight"].transpose(2, 0, 1)[::-1].copy(),
                "bias": state["bias"]}


def avg_pool1d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """[B, T, C] average pool along T with SAME padding, the padded zeros
    counted in every window (flax ``avg_pool``)."""
    lo, hi = same_pads(x.shape[1], window, stride)
    h = F.pad(x.transpose(1, 2), (lo, hi))
    return F.avg_pool1d(h, window, stride).transpose(1, 2)


def spectral_normalize(w: torch.Tensor, n_iter: int = 8,
                       eps: float = 1e-8) -> torch.Tensor:
    """A flax kernel [..., Cout] divided by the largest singular value of
    its [prod(...), Cout] matrix, floored at ``eps``
    (``ttsx/nn/conv.py::spectral_normalize``): ``n_iter`` power iterations
    that start cold from ``u = 1/sqrt(rows)`` on every call. ``u`` and
    ``v`` carry no gradient; the gradient flows through ``sigma = u . (W
    v)``. (Not ``torch.nn.utils.spectral_norm``, which keeps a warm random
    ``u``.) Runs inside an ``nn.spectral_normalize`` span."""
    with span("nn.spectral_normalize"):
        mat = w.reshape(-1, w.shape[-1])
        with torch.no_grad():
            m = mat.detach()
            u = torch.full((m.shape[0],), m.shape[0] ** -0.5, dtype=m.dtype,
                           device=m.device)
            for _ in range(n_iter):
                v = m.T @ u
                v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
                u = m @ v
                u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
        return w / torch.clamp_min(u @ (mat @ v), eps)


class SNConv(nn.Module):
    """Spectral-normalized 1-D or 2-D conv (``ttsx/nn/conv.py::SNConv``),
    SAME padding as XLA pads it, any strides. Works channels-first
    ([B, C, T] or [B, C, H, W]), the layout torch's convs take; the
    reference's channels-last maps are views of its outputs. Weight
    [Cout, Cin, *kernel_size]; the norm is taken over the flax kernel's
    [prod(kernel_size) * Cin, Cout] matrix.

    ``fits_kernel``: 1-D, stride 1, k odd and at least ``KERNEL_MIN_CH``
    channels in and out, each a multiple of 4 (the kernel copies rows of
    w, and of its transpose, 16 bytes at a time), the shapes where a
    tensor-core tile fills (at
    ``VocoderConfig()`` the scale discriminators' ``SNConv_3`` and
    ``SNConv_4``). Such a conv takes ``ops.conv1d_same`` for float32 CUDA
    tensors. Every forward adds its FLOPs, and those of the input gradient
    it will owe (grad mode on, x requiring a gradient), to the counter
    ``snconv.flops``, and those through the kernel to
    ``snconv.flops_kernel`` (``utils/spans.py``)."""

    KERNEL_MIN_CH = 64

    def __init__(self, in_channels: int, features: int, kernel_size,
                 strides=None, n_power_iter: int = 8):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides) if strides else (1,) * len(
            self.kernel_size)
        self.n_power_iter = n_power_iter
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features))

    def _flax_order(self):
        """The permutation of ``weight``'s axes into flax's (*k, Cin, Cout)."""
        n = len(self.kernel_size)
        return tuple(range(2, 2 + n)) + (1, 0)

    def normalized_weight(self) -> torch.Tensor:
        order = self._flax_order()
        k = spectral_normalize(self.weight.permute(order), self.n_power_iter)
        return k.permute([int(i) for i in np.argsort(order)])

    @property
    def fits_kernel(self) -> bool:
        cout, cin = self.weight.shape[:2]
        return (len(self.kernel_size) == 1 and self.strides == (1,)
                and self.kernel_size[0] % 2 == 1
                and min(cin, cout) >= self.KERNEL_MIN_CH
                and cin % 4 == 0 and cout % 4 == 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.normalized_weight()
        kernel = (self.fits_kernel and x.is_cuda
                  and x.dtype == w.dtype == torch.float32)
        y = self._conv(x, w, kernel)
        passes = 1 + (torch.is_grad_enabled() and x.requires_grad)
        flops = passes * 2.0 * y.numel() * (w.numel() // w.shape[0])
        count("snconv.flops", flops)
        if kernel:
            count("snconv.flops_kernel", flops)
        return y

    def _conv(self, x, w, kernel: bool) -> torch.Tensor:
        if kernel:
            return conv1d_same(x, w, self.bias)
        pads = []
        for t, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                           reversed(self.strides)):
            pads += same_pads(t, k, s)
        h = F.pad(x, pads)
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(h, w, self.bias, self.strides)

    def from_flax_leaves(self, leaves):
        k = np.asarray(leaves["kernel"])              # [*kernel, Cin, Cout]
        inv = np.argsort(self._flax_order())
        return {"weight": k.transpose(inv), "bias": leaves["bias"]}

    def to_flax_leaves(self, state):
        return {"kernel": state["weight"].transpose(self._flax_order()),
                "bias": state["bias"]}
