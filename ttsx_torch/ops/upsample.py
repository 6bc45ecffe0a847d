"""K1: the generator's ConvTranspose1d upsample, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/upsample_kernel.py``
(``_upsample_impl``, body ``_upsample_body``; public
``upsample_lrelu_pallas``), which the generator calls with
``lrelu=False`` once per stage. The CUDA source is ``csrc/upsample.cu``.

What bounds it on the H100: operations at the generator's first two stages,
bytes at the last two. The kernel is an implicit GEMM (M = input rows, N =
f*Cout, K = Cin for each of a column's two tap banks) on the tensor cores in
3xTF32: each f32 operand is split into two TF32 parts and three TF32
products are summed in f32, which keeps the error near f32's, so the f32
gates hold; see the source's header for the tiles.

``convt_upsample`` launches the kernel for a CUDA tensor and runs
``convt_upsample_plain`` (the same tap-bank arithmetic in PyTorch) for a CPU
tensor; any other device raises. Both take x and the weights in float32,
bfloat16 or float16, compute in float32 and return x's dtype, as the
reference kernel does (its products are float32, its output cast back to
x.dtype).
"""
from __future__ import annotations

import torch

from ttsx_torch.ops import build


def tap_banks(w: torch.Tensor, f: int):
    """Split a [2f, Cin, Cout] ConvTranspose kernel (tap-major) into the
    prev/cur/next banks [Cin, f*Cout] that act on frames t-1, t, t+1.

    With c = f // 2, phase j of output row t*f + j takes tap 2f-1-j-c from
    frame t, and tap 3f-1-j-c from t+1 (j >= f-c) or f-1-j-c from t-1."""
    k, cin, cout = w.shape
    c = f // 2
    zeros = torch.zeros_like(w[0])
    banks = {"prev": [], "cur": [], "next": []}
    for j in range(f):
        for name, i in (("prev", f - 1 - j - c), ("cur", 2 * f - 1 - j - c),
                        ("next", 3 * f - 1 - j - c)):
            banks[name].append(w[i] if 0 <= i < k else zeros)
    return tuple(torch.stack(banks[n], dim=1).reshape(cin, f * cout)
                 for n in ("prev", "cur", "next"))


def convt_taps(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               f: int) -> torch.Tensor:
    """x [B, T, Cin], w [2f, Cin, Cout] (tap-major), b [Cout], all of one
    dtype, computed in it -> ConvTranspose1d(k=2f, stride=f) cropped to
    [B, T*f, Cout]."""
    if w.shape[0] != 2 * f:
        raise ValueError(f"kernel has {w.shape[0]} taps, expected 2*{f}")
    B, T, _ = x.shape
    cout = w.shape[2]
    w_prev, w_cur, w_next = tap_banks(w, f)
    x_prev = torch.nn.functional.pad(x[:, :-1], (0, 0, 1, 0))
    x_next = torch.nn.functional.pad(x[:, 1:], (0, 0, 0, 1))
    y = x @ w_cur + x_next @ w_next + x_prev @ w_prev
    return y.reshape(B, T * f, cout) + b


def convt_upsample_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         f: int) -> torch.Tensor:
    """K1's plain version: ``convt_taps`` on the operands cast as the
    kernel casts them (``build.as_f32``), returned in x's dtype."""
    return convt_taps(*build.as_f32(x, w, b), f).to(x.dtype)


def convt_upsample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             f: int) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return convt_upsample_plain(x, w, b, f)
    return _launch(x, w, b, f)


convt_upsample.launches = 0


def _launch(x, w, b, f):
    if x.device.type != "cuda":
        raise ValueError(f"upsample: unsupported device {x.device}")
    dtype = x.dtype
    x, w, b = build.as_f32(x, w, b)
    B, T, cin = build.check_tensor(x, 3, "x")
    k, wcin, cout = build.check_tensor(w, 3, "w")
    build.check_tensor(b, 1, "b")
    if k != 2 * f or wcin != cin or b.shape[0] != cout:
        raise ValueError(f"upsample: w {tuple(w.shape)} / b {tuple(b.shape)}"
                         f" do not fit x {tuple(x.shape)} at f={f}")
    if cout % 4:
        raise ValueError(f"upsample kernel needs Cout % 4 == 0, got {cout}")
    for t in (w, b):
        if t.device != x.device:
            raise ValueError("upsample: tensors on different devices")
    lib = build.load("upsample")
    y = torch.empty((B, T * f, cout), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ttsx_upsample_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                   y.data_ptr(), B, T, cin, cout, f, stream)
    build.check(rc, "ttsx_upsample_f32")
    convt_upsample.launches += 1
    return y.to(dtype)
