"""K5: one FiLM residual block with full-rate FiLM, as a CUDA kernel for
Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/resblock_kernel.py``
(``_resblock_impl``, body ``_make_kernel``; public
``film_resblock_pallas``), which the reference runs per block through
``FiLMResidualBlock(use_pallas=True)``. The CUDA source is
``csrc/resblock.cu``; it shares its device code with K2
(``csrc/film_resblock.cuh``), run with one block and the scale and shift
read through their own pointers.

What bounds it on the H100: 18*C^2 flops per row against 16*C bytes (x,
scale and shift read, y written), counting three TF32 products per f32
product on the tensor cores, where the shared device code runs both
convs in 3xTF32: operations at C >= 64, bytes at C <= 32.

K5 is forward-only, as the reference kernel (no VJP there): on a CUDA
tensor a call that would need a gradient raises. ``film_resblock``
launches the kernel for a CUDA tensor and runs ``film_resblock_plain``
for a CPU tensor; any other device raises. Both take their operands in
float32, bfloat16 or float16, compute in float32 and return x's dtype,
as the reference kernel does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ttsx_torch.ops import build

HALO = 8   # the reference kernel's loaded halo: dilation + 1 must fit


def conv3(h: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """k=3 conv at dilation d with zero padding: taps at t-d, t, t+d;
    w [3, Cin, Cout]."""
    T = h.shape[1]
    hp = F.pad(h, (0, 0, d, d))
    return (hp[:, :T] @ w[0] + hp[:, d:d + T] @ w[1]
            + hp[:, 2 * d:2 * d + T] @ w[2])


def film_resblock_plain(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        dilation: int) -> torch.Tensor:
    """x, scale, shift [B, T, C]; w1 [3, C, 2C]; b1 [2C]; w2 [3, C, C];
    b2 [C] -> x + conv3(lrelu(glu(conv3_d(lrelu(x))) * (1 + scale) +
    shift)), computed on the operands cast as the kernel casts them
    (``build.as_f32``) and returned in x's dtype."""
    dtype = x.dtype
    x, scale, shift, w1, b1, w2, b2 = build.as_f32(x, scale, shift, w1, b1,
                                                   w2, b2)
    C = x.shape[-1]
    u = conv3(F.leaky_relu(x, 0.1), w1, dilation) + b1
    g = u[..., :C] * torch.sigmoid(u[..., C:])
    g = F.leaky_relu(g * (1.0 + scale) + shift, 0.1)
    return (x + conv3(g, w2, 1) + b2).to(dtype)


def film_resblock(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, dilation: int) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return film_resblock_plain(x, scale, shift, w1, b1, w2, b2, dilation)
    return _launch(x, scale, shift, w1, b1, w2, b2, dilation)


film_resblock.launches = 0


def _launch(x, scale, shift, w1, b1, w2, b2, dilation):
    if x.device.type != "cuda":
        raise ValueError(f"resblock: unsupported device {x.device}")
    args = (x, scale, shift, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("resblock: K5 is forward-only and has no "
                           "gradient; run it under torch.no_grad()")
    dtype = x.dtype
    args = build.as_f32(*args)
    x, scale, shift, w1, b1, w2, b2 = args
    B, T, C = build.check_tensor(x, 3, "x")
    shapes = {"scale": (scale, (B, T, C)), "shift": (shift, (B, T, C)),
              "w1": (w1, (3, C, 2 * C)), "b1": (b1, (2 * C,)),
              "w2": (w2, (3, C, C)), "b2": (b2, (C,))}
    for name, (t, want) in shapes.items():
        if build.check_tensor(t, len(want), name) != want:
            raise ValueError(f"resblock: {name} {tuple(t.shape)} != {want}")
    if not 1 <= dilation < HALO:
        raise ValueError(f"resblock: dilation {dilation} outside 1..{HALO - 1}")
    if C % 4:
        raise ValueError(f"resblock kernel needs C % 4 == 0, got {C}")
    if any(t.device != x.device for t in args):
        raise ValueError("resblock: tensors on different devices")
    lib = build.load("resblock")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ttsx_resblock_f32(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), B, T,
            C, dilation, stream)
    build.check(rc, "ttsx_resblock_f32")
    film_resblock.launches += 1
    return y.to(dtype)
