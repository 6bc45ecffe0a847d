"""Device selection and the numerics the port states on the card."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_f32_numerics() -> None:
    """Full-f32 matmuls and convolutions on the card: no TF32 anywhere,
    and bf16 matmuls reduce in f32, as XLA's bf16 dots do (the bf16
    server's products with two bf16 operands).

    cuDNN convolutions default to TF32 (about three decimal digits), and
    this model's quality readout has moved with matmul precision before.
    cuBLAS may otherwise reduce a bf16 product's split-K partial sums in
    bf16."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")
