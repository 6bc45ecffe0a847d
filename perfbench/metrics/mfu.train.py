"""The training window's share of the card's peak: the matmul,
convolution and attention FLOPs (forward and backward) of the window's
engine steps outside the traced stretch, counted by ``FlopCounterMode``
over the frozen reference's blocks on the meta device at each step's
shapes, over those steps' wall time, over the TF32 peak (495 TFLOP/s)."""
from perfbench.peaks import TF32_FLOPS


def read(record):
    if record.get("kind") != "train" or record.get("device") != "cuda":
        return None
    if not record.get("untraced_flops") or record["untraced_s"] <= 0.0:
        return None
    return 100.0 * record["untraced_flops"] / record["untraced_s"] \
        / TF32_FLOPS
