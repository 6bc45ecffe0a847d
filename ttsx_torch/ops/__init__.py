"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor, runs the plain
version for a CPU tensor, and raises on anything else; there is no
fallback from the card to PyTorch. ``launches`` on each wrapper counts
kernel launches.
"""
from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                           film_resblock_stack_plain)
from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain

KERNELS = {"upsample": convt_upsample, "resblock_stack": film_resblock_stack}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
