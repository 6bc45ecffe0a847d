"""K2: a generator stage's FiLM residual blocks, as one CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/resblock_stack_kernel.py``
(``_stack_impl``, body ``_make_kernel``; public
``film_resblock_stack_pallas`` in ``resblock_stack_vmap.py``), which the
generator calls once per stage with all blocks (dilations 1, 3, 5). The
CUDA source is ``csrc/resblock_stack.cu``.

What bounds it on the H100: operations, 54*C^2 flops per row per stage
against 8*C bytes of input and output. The kernel keeps a time tile plus
a halo of sum(d+1) rows per side in shared memory through all blocks, so
no intermediate reaches device memory, and runs both convs of each block
as GEMMs on the tensor cores in 3xTF32 (three TF32 products per f32
product, at an error near f32's), with the GLU and FiLM in registers;
the film comes in at the conditioning rate and each row is gathered
with ``(t * Tf) // T``. Its device code (``csrc/film_resblock.cuh``) is
shared with K5, and its plain version runs K5's plain version block by
block.

``film_resblock_stack`` launches the kernel for a CUDA tensor and runs
``film_resblock_stack_plain`` for a CPU tensor; any other device raises.
Both take their operands in float32, bfloat16 or float16, compute in
float32 and return x's dtype, as the reference kernel does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ttsx_torch.ops import build
from ttsx_torch.ops.resblock import film_resblock_plain

MAX_BLOCKS = 4


def nearest_rows(t: int, tc: int, device=None) -> torch.Tensor:
    """Row of a [.., tc, ..] conditioning tensor that time step t of t
    steps reads: ``(t * tc) // t`` in integers (never F.interpolate,
    whose float scale can land on other rows)."""
    idx = torch.arange(t, device=device, dtype=torch.int64) * tc // t
    return idx.clamp_(0, tc - 1)


def film_resblock_stack_plain(x: torch.Tensor, film: torch.Tensor,
                         w1s: torch.Tensor, b1s: torch.Tensor,
                         w2s: torch.Tensor, b2s: torch.Tensor,
                         dilations: Sequence[int]) -> torch.Tensor:
    """x [B, T, C]; film [Bf, Tf, 2nC] (scale_i | shift_i per block, at
    any rate Tf, batch Bf dividing B: row b of x reads film b % Bf);
    w1s [n, 3, C, 2C]; b1s [n, 2C]; w2s [n, 3, C, C]; b2s [n, C].
    Computed on the operands cast as the kernel casts them
    (``build.as_f32``), returned in x's dtype."""
    dtype = x.dtype
    x, film, w1s, b1s, w2s, b2s = build.as_f32(x, film, w1s, b1s, w2s, b2s)
    B, T, C = x.shape
    Bf, Tf = film.shape[:2]
    rows = nearest_rows(T, Tf, x.device)
    for i, d in enumerate(dilations):
        fi = film[:, :, 2 * i * C:(2 * i + 2) * C][:, rows]
        fi = fi.repeat(B // Bf, 1, 1)
        x = film_resblock_plain(x, fi[..., :C], fi[..., C:], w1s[i], b1s[i],
                                w2s[i], b2s[i], d)
    return x.to(dtype)


def film_resblock_stack(x: torch.Tensor, film: torch.Tensor, w1s: torch.Tensor,
                   b1s: torch.Tensor, w2s: torch.Tensor, b2s: torch.Tensor,
                   dilations: Sequence[int]) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return film_resblock_stack_plain(x, film, w1s, b1s, w2s, b2s, dilations)
    return _launch(x, film, w1s, b1s, w2s, b2s, tuple(dilations))


film_resblock_stack.launches = 0


def _launch(x, film, w1s, b1s, w2s, b2s, dilations):
    if x.device.type != "cuda":
        raise ValueError(f"resblock_stack: unsupported device {x.device}")
    dtype = x.dtype
    x, film, w1s, b1s, w2s, b2s = build.as_f32(x, film, w1s, b1s, w2s, b2s)
    B, T, C = build.check_tensor(x, 3, "x")
    Bf, Tf, fw = build.check_tensor(film, 3, "film")
    n = len(dilations)
    shapes = {"w1s": (w1s, (n, 3, C, 2 * C)), "b1s": (b1s, (n, 2 * C)),
              "w2s": (w2s, (n, 3, C, C)), "b2s": (b2s, (n, C))}
    for name, (t, want) in shapes.items():
        if build.check_tensor(t, len(want), name) != want:
            raise ValueError(f"resblock_stack: {name} {tuple(t.shape)} != "
                             f"{want}")
    if not 1 <= n <= MAX_BLOCKS or min(dilations) < 1:
        raise ValueError(f"resblock_stack: dilations {dilations}")
    if fw != 2 * n * C or B % Bf:
        raise ValueError(f"resblock_stack: film {tuple(film.shape)} does not "
                         f"fit x {tuple(x.shape)} with {n} blocks")
    if C % 4:
        raise ValueError(f"resblock_stack kernel needs C % 4 == 0, got {C}")
    if any(t.device != x.device for t in (film, w1s, b1s, w2s, b2s)):
        raise ValueError("resblock_stack: tensors on different devices")
    lib = build.load("resblock_stack")
    y = torch.empty_like(x)
    d = list(dilations) + [0] * (MAX_BLOCKS - n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ttsx_resblock_stack_f32(
            x.data_ptr(), film.data_ptr(), w1s.data_ptr(), b1s.data_ptr(),
            w2s.data_ptr(), b2s.data_ptr(), y.data_ptr(), B, T, C, Bf, Tf,
            n, *d, stream)
    build.check(rc, "ttsx_resblock_stack_f32")
    film_resblock_stack.launches += 1
    return y.to(dtype)
