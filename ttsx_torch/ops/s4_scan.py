"""K4: the causal diagonal-SSM recurrence of the S4 layer, as a CUDA kernel
for Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/s4_kernel.py``
(``s4_scan_pallas``, body ``_s4_head_kernel``), which an S4 layer with
``kernel_mode="pallas"`` runs: on the zoo refiner, 15 layers a pass. The
CUDA source is ``csrc/s4_scan.cu``.

What it computes: u [B, T, C = H*e] -> y [B, T, C]; channel (h, j) holds
d states ``s_t = exp(clip(a[h], -50, 50)) * s_{t-1} + b[h] * u_t`` from
zero at t = 0 and reads out ``y_t = sum_m c_full[h, m, j] * s_t[m]``.

What bounds it on the H100: f32 operations, about 4 B T C d (update plus
readout) against 8 B T C bytes of input and output. The TPU kernel's
per-chunk Toeplitz products are about T_chunk times that work and are not
carried over: the kernel runs the recurrence itself, one warp per
channel with its modes in registers (see the source's header). To fill
the card at batch 1 it cuts time into chunks of ``chunk_len`` steps: a
first pass writes each chunk's end state from zero (scratch [B, n-1, C,
d]), the second runs every chunk again from its carried-in state with
the readout.

K4 is forward-only, as the reference kernel (no VJP there): on a CUDA
tensor a call that would need a gradient raises. ``s4_scan`` launches the
kernel for a CUDA tensor and runs ``scan_dw_conv`` (the plain version)
for a CPU tensor; any other device raises.
"""
from __future__ import annotations

import torch

from ttsx_torch.ops import build

MAX_MODES = 288      # d <= 9 modes per lane x 32 lanes
GROUP = 32           # time steps per register group (chunks are multiples)
WARPS_PER_SM = 16    # chunks are cut until about this many warps per SM


def chunk_len(B: int, T: int, C: int, sms: int) -> int:
    """Time steps per chunk: the longest multiple of 32 that still gives
    about ``WARPS_PER_SM * sms`` warps (one per batch row, channel and
    chunk); T rounded up to 32 when B * C alone fills the card."""
    want = -(-WARPS_PER_SM * sms // (B * C))
    per = -(-T // max(1, want))
    return -(-per // GROUP) * GROUP


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
        ys.append(torch.einsum("bhed,hde->bhe", s, c_full))
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
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    L = chunk_len(B, T, C, sms)
    n_chunks = -(-T // L)
    y = torch.empty_like(u)
    state = torch.empty((B, n_chunks - 1, C, d), device=u.device,
                        dtype=torch.float32)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = lib.ttsx_s4_scan_f32(
            u.data_ptr(), a_diag.data_ptr(), b.data_ptr(), c_full.data_ptr(),
            state.data_ptr(), y.data_ptr(), B, T, C, H, d, L, stream)
    build.check(rc, "ttsx_s4_scan_f32")
    s4_scan.launches += 1
    return y
