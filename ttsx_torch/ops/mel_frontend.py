"""K3: the collator's log-mel frontend, as a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``ttsx/ops/mel_kernel.py``
(``mel_frontend_pallas``, body ``_mel_kernel``), which ``TTSCollator``
runs on every batch. The CUDA source is ``csrc/mel_frontend.cu``.

What it computes, frame by frame: reflect-padded centred frames x Hann
window -> real DFT -> ``sqrt(re^2 + im^2 + 1e-12)`` -> mel filterbank ->
``log(mel + 1e-5)``. The 1e-12 floor and the 1e-5 are the kernel's own
constants, as in the reference kernel (it does not read
``AudioConfig.log_eps``). On an all-zero frame this reads higher than
``ttsx_torch.dsp.stft.mel_spectrogram`` (plain ``|rfft|``, 0 there); the
collator zero-pads every wav to its bucket, and the port follows this
kernel, the reference's route on its accelerator, on every device.

The kernel takes the DFT by dense bases, as the reference kernel does:
2.18 MFLOP a frame at n_fft 1024, 80 mels, about 70x what the function
needs; see the source's header for why.

``log_mel`` launches the kernel for a CUDA tensor and runs
``log_mel_plain`` (the reference kernel's steps in PyTorch: reflect pad,
frame gather, window, cos/sin basis products, floor, filterbank, log)
for a CPU tensor; any other device raises. ``mel_frontend`` adds the
per-bin normalisation outside the kernel when ``cfg.mel_normalize``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.dsp.stft import mel_filterbank, normalize_mel, padded_window
from ttsx_torch.ops import build

MAG_FLOOR = 1e-12   # added to re^2 + im^2 inside the kernel
LOG_EPS = 1e-5      # added to the mel before the log inside the kernel


def dft_bases(n_fft: int):
    """cos / sin of -2 pi n k / n_fft, [n_fft, n_fft//2 + 1] f32 each."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _cfg_key(cfg: AudioConfig):
    return (cfg.sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels,
            cfg.f_min, cfg.f_max)


@functools.lru_cache(maxsize=8)
def _constants(key, device: str, bases: bool):
    sr, n_fft, win_length, n_mels, f_min, f_max = key
    cfg = AudioConfig(sample_rate=sr, n_fft=n_fft, win_length=win_length,
                      n_mels=n_mels, f_min=f_min, f_max=f_max)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                     device=device)
    win = as_t(padded_window(cfg))
    fb = as_t(mel_filterbank(sr, n_fft, n_mels, f_min, f_max))
    if bases:
        cos, sin = dft_bases(n_fft)
        return win, fb, as_t(cos), as_t(sin)
    j = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return win, fb, as_t(np.stack([np.cos(j), np.sin(j)]))


def log_mel_plain(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [B, N] f32 -> unnormalised log-mel [B, T, n_mels], step by step
    as the reference kernel: the plain version of K3."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    win, fb, cos, sin = _constants(_cfg_key(cfg), str(wav.device), True)
    padded = F.pad(wav.float()[:, None], (n_fft // 2, n_fft // 2),
                   mode="reflect")[:, 0]
    T = 1 + (padded.shape[-1] - n_fft) // hop
    idx = (torch.arange(T, device=wav.device)[:, None] * hop
           + torch.arange(n_fft, device=wav.device)[None, :])
    frames = padded[:, idx] * win
    re = frames @ cos
    im = frames @ sin
    mag = torch.sqrt(re * re + im * im + MAG_FLOOR)
    return torch.log(mag @ fb + LOG_EPS)


def log_mel(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if wav.device.type == "cpu":
        return log_mel_plain(wav, cfg)
    return _launch(wav, cfg)


log_mel.launches = 0


def mel_frontend(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [B, N] -> log-mel [B, T, n_mels] through K3, per-bin normalised
    over time (population std + 1e-5) when ``cfg.mel_normalize``."""
    mel = log_mel(wav, cfg)
    return normalize_mel(mel) if cfg.mel_normalize else mel


def _launch(wav, cfg):
    if wav.device.type != "cuda":
        raise ValueError(f"mel_frontend: unsupported device {wav.device}")
    B, N = build.check_tensor(wav, 2, "wav")
    if N <= cfg.n_fft // 2:
        raise ValueError(f"mel_frontend: {N} samples cannot be reflect-padded"
                         f" by n_fft/2 = {cfg.n_fft // 2}")
    if cfg.n_fft % 2 or cfg.n_fft > 2048 or cfg.win_length > cfg.n_fft:
        raise ValueError(f"mel_frontend kernel needs an even n_fft <= 2048 "
                         f"and win_length <= n_fft, got {cfg.n_fft} / "
                         f"{cfg.win_length}")
    lib = build.load("mel_frontend")
    win, fb, twiddle = _constants(_cfg_key(cfg), str(wav.device), False)
    out = torch.empty((B, 1 + N // cfg.hop_length, cfg.n_mels),
                      device=wav.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    with torch.cuda.device(wav.device):
        rc = lib.ttsx_mel_frontend_f32(
            wav.data_ptr(), win.data_ptr(), twiddle.data_ptr(), fb.data_ptr(),
            out.data_ptr(), B, N, cfg.n_fft, cfg.hop_length, cfg.n_mels,
            stream)
    build.check(rc, "ttsx_mel_frontend_f32")
    log_mel.launches += 1
    return out
