"""The serving window's share of the card's peak: the matmul, convolution
and attention FLOPs of one bucket, counted by ``FlopCounterMode`` over
the frozen reference at the bucket's shapes, times the calls served
outside the traced stretch, over their wall time, over the TF32 peak
(495 TFLOP/s)."""
from perfbench.peaks import TF32_FLOPS


def read(record):
    if record.get("kind") != "serve" or record.get("device") != "cuda":
        return None
    if not record.get("flops_per_call"):
        return None
    if record["untraced_s"] <= 0.0:
        return None
    rate = record["flops_per_call"] * record["untraced_calls"] \
        / record["untraced_s"]
    return 100.0 * rate / TF32_FLOPS
