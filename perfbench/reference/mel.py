"""K3's plain maths in float64: the unnormalised log-mel of a wav batch.

Reflect padding by n_fft / 2, the Hann window of ``win_length`` centred
in n_fft, a float64 real FFT every hop, magnitudes with 1e-12 under the
square root, the HTK filterbank and 1e-5 under the log, as the kernel
states them (``ttsx_torch/ops/mel_frontend.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.dsp.stft import mel_filterbank, padded_window

MAG_FLOOR = 1e-12
LOG_EPS = 1e-5


def log_mel_f64(wav: torch.Tensor, audio: dict,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """wav [B, N] -> log-mel [B, 1 + N // hop, n_mels], computed in
    ``dtype`` (float64; float32 is the control's)."""
    from perfbench.reference.core.config import AudioConfig
    cfg = AudioConfig(**audio)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    x = F.pad(wav.to(dtype)[:, None], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    win = torch.as_tensor(padded_window(cfg), dtype=dtype,
                          device=wav.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + MAG_FLOOR)
    fb = torch.as_tensor(mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels,
                                        cfg.f_min, cfg.f_max),
                         dtype=dtype, device=wav.device)
    return torch.log(mag @ fb + LOG_EPS)
