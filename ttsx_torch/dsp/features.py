"""Frame-level f0, energy and an energy VAD (``ttsx/dsp/features.py``)
in PyTorch.

An autocorrelation pitch tracker over the mel frontend's framing:
mean removal, FFT autocorrelation, peak pick in the [fmin, fmax] lag
band. Runs on the wav's device.
"""
from __future__ import annotations

import torch

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.dsp.stft import frame_signal


def extract_f0_energy(wav: torch.Tensor, cfg: AudioConfig,
                      fmin: float = 65.0, fmax: float = 500.0):
    """wav [B, N] -> (f0 [B, T], energy [B, T], voiced [B, T])."""
    frames = frame_signal(wav.float(), cfg.win_length, cfg.hop_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    energy = torch.sqrt((frames ** 2).mean(dim=-1) + 1e-10)

    w = frames.shape[-1]
    n = 1 << (2 * w - 1).bit_length()
    spec = torch.fft.rfft(frames, n=n, dim=-1)
    ac = torch.fft.irfft(spec * spec.conj(), n=n, dim=-1)[..., :w]
    ac = ac / ac[..., :1].clamp_min(1e-10)

    lag_min = max(2, int(cfg.sample_rate / fmax))
    lag_max = min(w - 1, int(cfg.sample_rate / fmin))
    best = ac[..., lag_min:lag_max].argmax(dim=-1) + lag_min
    peak = torch.gather(ac, -1, best[..., None])[..., 0]

    voiced = (peak > 0.3) & (energy > 1e-3)
    f0 = torch.where(voiced, cfg.sample_rate / best.float(),
                     torch.zeros_like(energy))
    return f0, energy, voiced


def energy_vad(wav: torch.Tensor, cfg: AudioConfig,
               threshold: float = 0.02) -> torch.Tensor:
    """[B, T] voice activity: each frame's RMS above ``threshold`` times
    the utterance's loudest frame's (floored at 1e-6)."""
    frames = frame_signal(wav.float(), cfg.win_length, cfg.hop_length)
    rms = torch.sqrt((frames ** 2).mean(dim=-1) + 1e-10)
    ref = rms.amax(dim=-1, keepdim=True).clamp_min(1e-6)
    return rms > threshold * ref
