"""K4: the causal diagonal-SSM recurrence of the S4 layer, as chunked
3xTF32 tensor-core products for Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/s4_kernel.py``
(``s4_scan_pallas``, body ``_s4_head_kernel``), which an S4 layer with
``kernel_mode="pallas"`` runs: on the zoo refiner, 15 layers a pass. The
CUDA source is ``csrc/s4_scan.cu``.

What it computes: u [B, T, C = H*e] -> y [B, T, C]; channel (h, j) holds
d states ``s_t = exp(clip(a[h], -50, 50)) * s_{t-1} + b[h] * u_t`` from
zero at t = 0 and reads out ``y_t = sum_m c_full[h, m, j] * s_t[m]``.

What bounds it on the H100: operations, 4 B T C d of them against 8 B T
C bytes of input and output. The decays depend on the head and the
mode, not on the channel, so over a chunk of ``CHUNK`` steps the
recurrence is two products per head whose A operands are powers of the
decays: the chunk's end state from zero, ``Vend . U``, and its output
from the carried-in state, ``W . (cc * R)``, plus a local causal
convolution with the head's lag kernel (the source's header has the
algebra). The products run on the tensor cores in 3xTF32, at f32
accuracy. The TPU kernel's per-mode Toeplitz blocks, about ``CHUNK``
times that work, are not carried over. One launch: a CTA takes 8, 4 or 2
channels of one head and one batch row (``launch_geometry``) and walks
time in groups of chunks, ``ROWS`` (chunk, channel) rows at a time, with
the carried states in shared memory; each warp takes a share of the
modes and runs both products for them, the carry between chunks in its
registers, and the warps' sums meet in shared memory. Shared memory
grows with d, which caps it at ``MAX_MODES``.

K4 is forward-only, as the reference kernel (no VJP there): on a CUDA
tensor a call that would need a gradient raises. ``s4_scan`` launches the
kernel for a CUDA tensor and runs ``scan_dw_conv`` (the plain version)
for a CPU tensor; any other device raises. Both take their operands in
float32, bfloat16 or float16, compute in float32 and return u's dtype,
as the reference kernel does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ttsx_torch.ops import build

CHUNK = 32          # L, time steps per chunk (kChunk in the source)
ROWS = 32           # (chunk, channel) rows a CTA takes at once (kRows)
MAX_MODES = 872     # d that fits a CTA's shared memory (kMaxModes)


class Geometry(NamedTuple):
    """K4's launch for one call: chunk length, chunks, channels a CTA
    takes (8 where its CTAs number four per SM, else 4 where they cover
    the SMs, else 2), the
    groups of ROWS / channels chunks that a CTA walks in order, channel
    tiles per head (the grid is tiles x H x B) and the shared memory a
    CTA takes, in bytes."""
    L: int
    n_chunks: int
    channels: int
    groups: int
    tiles: int
    smem: int


def launch_geometry(B: int, T: int, C: int, H: int, d: int,
                    sms: int) -> Geometry:
    """The launch ``csrc/s4_scan.cu`` makes for u [B, T, C], H heads and
    d modes on a card with ``sms`` SMs. Shared memory: per mode (d
    rounded up to 8) the power table dec^0..dec^L, the readout weights
    and carried states of the tile's channels, and dec^L; then two u
    tiles of a group, the warps' partial outputs, the lag kernels and the
    local parts."""
    e = C // H
    kc = next((k for k, n in ((8, 4 * sms), (4, sms))
               if B * H * -(-e // k) >= n), 2)
    g = ROWS // kc
    d8 = -(-d // 8) * 8
    u_tile = g * (CHUNK * kc + (2 if kc == 2 else 4))
    units = kc * -(-g // 8)
    fixed = 2 * u_tile + 8 * ROWS * CHUNK + units * 2 * CHUNK + kc * g * CHUNK
    smem = 4 * (d8 * (CHUNK + 4 + 2 * kc + 1) + fixed)
    return Geometry(CHUNK, -(-T // CHUNK), kc, -(-T // (g * CHUNK)),
                    -(-e // kc), smem)


def scan_dw_conv(x: torch.Tensor, a_diag: torch.Tensor, b: torch.Tensor,
                 c_full: torch.Tensor) -> torch.Tensor:
    """Causal diagonal-SSM recurrence, step by step over time.

    x [B, T, C = H*e]; channel (h, j) carries the d states of its head:
    ``s_t = exp(clip(a, -50, 50)) * s_{t-1} + b * u_t`` from s = 0, and
    ``y_t[(h, j)] = sum_d c_full[h, d, j] * s_t[d]``: the function of
    ``fft_dw_conv`` with the materialized kernel, in recurrent form. Holds
    [B, C, d] states, never [B, T, C, d]."""
    B, T, C = x.shape
    H, d = a_diag.shape
    u = x.reshape(B, T, H, C // H).float()
    decay = torch.exp(torch.clamp(a_diag, -50.0, 50.0))[:, None, :]
    bb = b[:, None, :]
    s = x.new_zeros(B, H, C // H, d, dtype=torch.float32)
    ys = []
    for t in range(T):
        s = s * decay + u[:, t, :, :, None] * bb
        ys.append(torch.einsum("bhed,hde->bhe", s, c_full.float()))
    return torch.stack(ys, dim=1).reshape(B, T, C).to(x.dtype)


def s4_scan(u: torch.Tensor, a_diag: torch.Tensor, b: torch.Tensor,
            c_full: torch.Tensor) -> torch.Tensor:
    """K4 on a CUDA tensor, ``scan_dw_conv`` on a CPU tensor."""
    if u.device.type == "cpu":
        return scan_dw_conv(u, a_diag, b, c_full)
    return _launch(u, a_diag, b, c_full)


s4_scan.launches = 0


def _launch(u, a_diag, b, c_full):
    if u.device.type != "cuda":
        raise ValueError(f"s4_scan: unsupported device {u.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, a_diag, b, c_full)):
        raise RuntimeError("s4_scan: K4 is forward-only and has no "
                           "gradient; run the layer under torch.no_grad() "
                           "or with kernel_mode 'fft' or 'scan'")
    dtype = u.dtype
    u, a_diag, b, c_full = build.as_f32(u, a_diag, b, c_full)
    B, T, C = build.check_tensor(u, 3, "u")
    H, d = build.check_tensor(a_diag, 2, "a_diag")
    if C % H:
        raise ValueError(f"s4_scan: {C} channels do not split into {H} heads")
    e = C // H
    if build.check_tensor(b, 2, "b") != (H, d):
        raise ValueError(f"s4_scan: b {tuple(b.shape)} != {(H, d)}")
    if build.check_tensor(c_full, 3, "c_full") != (H, d, e):
        raise ValueError(f"s4_scan: c_full {tuple(c_full.shape)} != "
                         f"{(H, d, e)}")
    if not 1 <= d <= MAX_MODES:
        raise ValueError(f"s4_scan kernel takes 1..{MAX_MODES} modes, got {d}")
    if any(t.device != u.device for t in (a_diag, b, c_full)):
        raise ValueError("s4_scan: tensors on different devices")
    lib = build.load("s4_scan")
    y = torch.empty_like(u)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = lib.ttsx_s4_scan_f32(
            u.data_ptr(), a_diag.data_ptr(), b.data_ptr(), c_full.data_ptr(),
            y.data_ptr(), B, T, C, H, d, CHUNK, stream)
    build.check(rc, "ttsx_s4_scan_f32")
    s4_scan.launches += 1
    return y.to(dtype)
