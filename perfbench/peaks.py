"""The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W).

A roofline share and ``mfu`` count the operations the algorithm needs
over the fastest rate at which the card takes products of float32
inputs, TF32 on the tensor cores, and bytes over HBM's rate: the least
time any implementation could take, so that no correct kernel reads over
100 % whatever method it uses.
"""
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time for the work: the larger of the operations over the
    TF32 peak and the bytes over HBM's rate."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES)


def share_pct(least: float, measured: float):
    """``least / measured`` in %, or None where nothing was measured."""
    if measured <= 0.0:
        return None
    return 100.0 * least / measured
