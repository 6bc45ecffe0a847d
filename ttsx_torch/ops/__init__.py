"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises on anything else; there is no
fallback from the card to PyTorch. ``launches`` on each wrapper counts
kernel launches (``conv1d_same`` and ``conv1d_same_input_grad`` are one
kernel, counted by pass).
"""
from ttsx_torch.ops.conv1d_same import (conv1d_same, conv1d_same_input_grad,
                                        conv1d_same_plain)
from ttsx_torch.ops.mel_frontend import log_mel, log_mel_plain
from ttsx_torch.ops.resblock import film_resblock, film_resblock_plain
from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                           film_resblock_stack_plain)
from ttsx_torch.ops.s4_scan import s4_scan
from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain

KERNELS = {"upsample": convt_upsample, "resblock_stack": film_resblock_stack,
           "mel_frontend": log_mel, "s4_scan": s4_scan,
           "resblock": film_resblock, "conv1d_same": conv1d_same,
           "conv1d_same_input_grad": conv1d_same_input_grad}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
