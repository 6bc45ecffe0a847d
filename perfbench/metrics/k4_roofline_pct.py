"""K4 (the refiner's S4 recurrence, ``s4_chunked_kernel``): the least time
of its launches in the traced stretch over their device time.

For each S4 call the stretch ran, input u [B, T, C] over H heads of d
modes: the FLOPs are the least of two counts of the same function, the
recurrence (update and readout, 4 B T C d) and the materialized kernel
with an FFT convolution (decay times input gain 2 H T d, the kernel's
readout 2 T C d, real FFTs of u, of the kernel and the inverse at 2.5 n
log2 n each per channel with n the power of two >= 2T - 1, complex
products 6 (n/2 + 1) per channel); bytes: u read and y written once,
the decays, input gains and readout [H, d, C/H], in float32."""
import math

from perfbench.peaks import least_s, share_pct
from perfbench.trace import kernel_time


def match(name: str) -> bool:
    return "s4_chunked_kernel" in name


def cost(B: int, T: int, C: int, H: int, d: int):
    n = 1 << (2 * T - 2).bit_length()
    rec = 4 * B * T * C * d
    fft = (2 * H * T * d + 2 * T * C * d + 6 * B * C * (n // 2 + 1)
           + (2 * B + 1) * C * 2.5 * n * math.log2(n))
    nbytes = 4 * (2 * B * T * C + 2 * H * d + H * d * (C // H))
    return min(rec, fft), nbytes


def read(record):
    if record.get("kind") != "serve":
        return None
    measured, launches = kernel_time(record["trace"], match)
    shapes = record.get("s4_shapes", [])
    if launches == 0 or launches != len(shapes):
        return None
    least = sum(least_s(*cost(*s)) for s in shapes)
    return share_pct(least, measured)
