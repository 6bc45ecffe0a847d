"""STFT / mel-spectrogram frontend (``ttsx/dsp/stft.py``) in PyTorch.

The window and filterbank are numpy, as in the reference; framing,
magnitude and the mel projection are torch ops on the wav's device. This
is the reference's plain ``|rfft|`` route; the collator's route is the
mel-frontend kernel K3 (``ttsx_torch/ops/mel_frontend.py``), which
floors the magnitude at ``sqrt(1e-12)`` and so differs on silent frames.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ttsx_torch.core.config import AudioConfig


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window(n)``), float64."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """HTK-style triangular filterbank [n_fft//2+1, n_mels], float32."""
    f_max = f_max or sr / 2.0
    n_bins = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def padded_window(cfg: AudioConfig) -> np.ndarray:
    """The Hann window of ``win_length`` centred in ``n_fft`` samples."""
    win = hann_window(cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        pad = (cfg.n_fft - cfg.win_length) // 2
        win = np.pad(win, (pad, cfg.n_fft - cfg.win_length - pad))
    return win


def frame_signal(wav: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """wav [B, N] -> frames [B, T, n_fft] (reflect-padded when centred)."""
    if center:
        wav = F.pad(wav[:, None], (n_fft // 2, n_fft // 2),
                    mode="reflect")[:, 0]
    t = 1 + (wav.shape[-1] - n_fft) // hop
    return wav.unfold(-1, n_fft, hop)[:, :t]


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int,
                   win_length: int | None = None,
                   center: bool = True) -> torch.Tensor:
    """wav [B, N] -> |STFT| [B, T, n_fft//2+1], in float32 (float64 for
    a float64 wav)."""
    win_length = win_length or n_fft
    frames = frame_signal(wav.to(torch.promote_types(wav.dtype,
                                                     torch.float32)),
                          n_fft, hop, center)
    win = torch.as_tensor(
        padded_window(AudioConfig(n_fft=n_fft, win_length=win_length)),
        dtype=frames.dtype, device=wav.device)
    return torch.fft.rfft(frames * win, dim=-1).abs()


def normalize_mel(mel: torch.Tensor) -> torch.Tensor:
    """Per-bin normalisation over time with the population std + 1e-5."""
    mean = mel.mean(dim=1, keepdim=True)
    std = mel.std(dim=1, keepdim=True, unbiased=False) + 1e-5
    return (mel - mean) / std


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [B, N] -> log-mel [B, T, n_mels]: |STFT| @ filterbank, then
    ``log(mel + log_eps)``, then the per-bin normalisation if asked; in
    float32 whatever the wav's dtype."""
    mag = stft_magnitude(wav.float(), cfg.n_fft, cfg.hop_length,
                         cfg.win_length)
    fb = torch.as_tensor(mel_filterbank(cfg.sample_rate, cfg.n_fft,
                                        cfg.n_mels, cfg.f_min, cfg.f_max),
                         device=wav.device)
    mel = torch.log(mag @ fb + cfg.log_eps)
    return normalize_mel(mel) if cfg.mel_normalize else mel
