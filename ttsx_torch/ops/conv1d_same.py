"""A 1-D SAME convolution with stride 1 and odd k on the tensor cores, for
the discriminators' wide ``SNConv`` layers (``nn/conv.py``).

Replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
cuDNN runs them in float32 on the FMA pipes (TF32 is off, as the training
gates need); the CUDA kernel (``csrc/conv1d_same.cu``) is an implicit GEMM
on wgmma in 3xTF32, f32 accuracy at the tensor cores' rate, bound by
operations. Its header gives the design and the measured rates.

    y[b, co, t] = sum_{ci, j} w[co, ci, j] * x[b, ci, t + j - p] (+ b[co])

with x [B, Cin, T], w [Cout, Cin, k], k odd, p = (k - 1) / 2 and zeros
outside [0, T): ``F.conv1d`` of x padded by p on both sides.

``conv1d_same`` launches the kernel for a CUDA tensor, inside an autograd
``Function`` whose backward takes the input gradient from the same kernel
(``conv1d_same_input_grad``: dx is the convolution of dy with w's channels
exchanged and its taps reversed, under the same padding) and the weight
gradient from cuDNN (``torch.nn.grad.conv1d_weight``); it computes only
the gradients its inputs need, and its backward is itself differentiable
(R1's double backward). For a CPU tensor both run their plain versions
(``F.pad`` + ``F.conv1d``); any other device raises, and so does a CUDA
tensor whose channels (Cin forward, Cout for the input gradient) are not a
multiple of 4. ``launches`` on each
counts the kernel's launches: ``conv1d_same`` the forward passes,
``conv1d_same_input_grad`` the input gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ttsx_torch.ops import build


def _pad(w: torch.Tensor) -> int:
    k = w.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"conv1d_same: k must be odd, got {k}")
    return (k - 1) // 2


def flipped(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's weight: [Cin, Cout, k], taps reversed."""
    return w.transpose(0, 1).flip(-1).contiguous()


def conv1d_same_plain(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor = None) -> torch.Tensor:
    """The plain version: ``F.conv1d`` of x padded by p on both sides."""
    p = _pad(w)
    return F.conv1d(F.pad(x, (p, p)), w, b)


def conv1d_same_input_grad_plain(dy: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv1d_same_plain`` for dy [B, Cout, T]: the same
    convolution of dy with ``flipped(w)``."""
    return conv1d_same_plain(dy, flipped(w))


class ConvSame(torch.autograd.Function):
    """y = conv1d_same(x, w, b): forward and input gradient on the kernel
    (the plain version for CPU tensors), the weight gradient on cuDNN."""

    @staticmethod
    def forward(ctx, x, w, b, input_grad: bool = False):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return conv1d_same_plain(x, w, b)
        y = _launch(x, w, b)
        fn = conv1d_same_input_grad if input_grad else conv1d_same
        fn.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = ConvSame.apply(dy, flipped(w), None, True)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(x, w.shape, dy, padding=_pad(w))
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 2))
        return dx, dw, db, None


def conv1d_same(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor = None) -> torch.Tensor:
    """The kernel (with its gradients) for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.device.type == "cpu":
        return conv1d_same_plain(x, w, b)
    return ConvSame.apply(x, w, b)


def conv1d_same_input_grad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``conv1d_same`` (w [Cout, Cin, k], dy [B, Cout, T]): the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if dy.device.type == "cpu":
        return conv1d_same_input_grad_plain(dy, w)
    return ConvSame.apply(dy, flipped(w), None, True)


conv1d_same.launches = 0
conv1d_same_input_grad.launches = 0


def _launch(x, w, b):
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same: unsupported device {x.device}")
    x, w = x.contiguous(), w.contiguous()
    B, cin, T = build.check_tensor(x, 3, "x")
    cout, wcin, k = build.check_tensor(w, 3, "w")
    _pad(w)
    if wcin != cin:
        raise ValueError(f"conv1d_same: w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if cin % 4:
        raise ValueError(f"conv1d_same: {cin} input channels, the kernel "
                         "takes a multiple of 4")
    if w.data_ptr() % 16:   # the kernel copies w's rows 16 bytes at a time
        w = w.clone()
    if b is not None:
        b = b.contiguous()
        build.check_tensor(b, 1, "b")
        if b.shape[0] != cout:
            raise ValueError(f"conv1d_same: b {tuple(b.shape)} for Cout {cout}")
    for t in (w, b):
        if t is not None and t.device != x.device:
            raise ValueError("conv1d_same: tensors on different devices")
    lib = build.load("conv1d_same")
    y = torch.empty((B, cout, T), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ttsx_conv1d_same_f32(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), B, cin, T, cout, k, stream)
    build.check(rc, "ttsx_conv1d_same_f32")
    return y
