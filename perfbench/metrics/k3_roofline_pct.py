"""K3 (the collator's log-mel, ``mel_fft_kernel``): the least time of its
launches in the traced stretch over their device time.

For each collated batch [B, N] (reflect-padded, 1 + N // hop frames a
row): per frame the window n_fft, a real FFT 2.5 n_fft log2 n_fft,
magnitudes 4 bins, the filterbank's nonzero taps 2 nnz and the log
n_mels FLOPs; bytes: the wav read and the log-mel written once, the
window, twiddles and filterbank, in float32."""
import math

from perfbench.peaks import least_s, share_pct
from perfbench.trace import kernel_time


def match(name: str) -> bool:
    return "mel_fft_kernel" in name


def cost(B: int, N: int, audio: dict, nnz: int):
    n_fft, hop, mels = audio["n_fft"], audio["hop_length"], audio["n_mels"]
    bins = n_fft // 2 + 1
    frames = B * (1 + N // hop)
    nbytes = 4 * (B * N + frames * mels + 3 * n_fft + bins * mels)
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4 * bins
                 + 2 * nnz + mels)
    return frames * per_frame, nbytes


def read(record):
    if record.get("kind") != "train":
        return None
    measured, launches = kernel_time(record["trace"], match)
    shapes = record.get("k3_shapes", [])
    if launches == 0 or launches != len(shapes):
        return None
    least = sum(least_s(*cost(B, N, record["audio"], record["mel_nnz"]))
                for B, N in shapes)
    return share_pct(least, measured)
