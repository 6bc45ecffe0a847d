"""K1's plain maths: the generator's ConvTranspose1d upsample as tap
banks (a frozen copy of ``ttsx_torch/ops/upsample.py``'s plain version)."""
from __future__ import annotations

import torch



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
    return convt_taps(*as_f32(x, w, b), f).to(x.dtype)


def as_f32(*ts):
    """The operands in float32 (a 16-bit tensor becomes its float32 copy)."""
    return [t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
            for t in ts]
