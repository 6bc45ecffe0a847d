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

The kernel takes a real FFT in float64 in shared memory: the windowed
frame packed into an n_fft/2-point complex FFT (Stockham passes of
radix 8) and one split step, the filterbank by its nonzero taps, the
log, all in float64 and rounded to f32 once at the store. Its output is
the exact log-mel rounded to f32, which the plain version's dense f32
products are not on near-silent bands; see the source's header for the
design and what bounds it. The tables it reads are float64 and made here
on the host (``kernel_tables``). It takes a power-of-two n_fft from 64 to
2048 and hop <= n_fft (``check_geometry``); the reference kernel takes
any n_fft.

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
FFT_SIZES = tuple(1 << p for p in range(6, 12))   # K3's n_fft: 64 .. 2048


def dft_bases(n_fft: int):
    """cos / sin of -2 pi n k / n_fft, [n_fft, n_fft//2 + 1] f32 each."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _cfg_key(cfg: AudioConfig):
    return (cfg.sample_rate, cfg.n_fft, cfg.win_length, cfg.n_mels,
            cfg.f_min, cfg.f_max)


def _cfg(key) -> AudioConfig:
    sr, n_fft, win_length, n_mels, f_min, f_max = key
    return AudioConfig(sample_rate=sr, n_fft=n_fft, win_length=win_length,
                       n_mels=n_mels, f_min=f_min, f_max=f_max)


@functools.lru_cache(maxsize=8)
def _constants(key, device: str):
    """The plain version's f32 window, filterbank and cos / sin bases."""
    cfg = _cfg(key)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                     device=device)
    cos, sin = dft_bases(cfg.n_fft)
    return (as_t(padded_window(cfg)), as_t(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)),
        as_t(cos), as_t(sin))


def check_geometry(cfg: AudioConfig) -> None:
    """Raise unless K3 takes this frontend: a power-of-two n_fft in
    ``FFT_SIZES``, win_length <= n_fft and 0 < hop <= n_fft."""
    if (cfg.n_fft not in FFT_SIZES or cfg.win_length > cfg.n_fft
            or not 0 < cfg.hop_length <= cfg.n_fft):
        raise ValueError(
            f"mel_frontend kernel needs a power-of-two n_fft from "
            f"{FFT_SIZES[0]} to {FFT_SIZES[-1]}, win_length <= n_fft and "
            f"0 < hop <= n_fft, got n_fft {cfg.n_fft}, win_length "
            f"{cfg.win_length}, hop {cfg.hop_length}")


def radix_plan(n_fft: int) -> tuple:
    """The radices of the kernel's Stockham passes over n_fft/2 points:
    8, the last 16 or 4 where log2(n_fft/2) is not a multiple of 3 (the
    source's ``radix``)."""
    lg = (n_fft // 2).bit_length() - 1
    last = {0: (8,), 1: (16,), 2: (8, 4)}[lg % 3]
    return (8,) * (lg // 3 - 1) + last


def twiddles(n_fft: int) -> np.ndarray:
    """K3's twiddle table [entries, 2] (re, im), made in float64: for each
    Stockham pass after the first (radix R, Ns points combined) the
    factors e^(-2 pi i s r / (Ns R)) laid out [s][r - 1] (s < Ns, 1 <= r <
    R), then the split step's e^(-2 pi i k / n_fft), k = 0..n_fft/4."""
    parts, ns = [], 1
    for p, R in enumerate(radix_plan(n_fft)):
        if p:
            parts.append((np.arange(ns)[:, None] * np.arange(1, R)[None, :]
                          / (ns * R)).ravel())
        ns *= R
    parts.append(np.arange(n_fft // 4 + 1) / n_fft)
    ang = 2.0 * np.pi * np.concatenate(parts)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1)


def filterbank_taps(fb: np.ndarray):
    """Each mel's nonzero taps of ``fb`` [n_bins, n_mels]: the first bin
    [n_mels] int32, the offsets [n_mels + 1] int32 of each mel's weights
    in the packed float64 weights, which run from its first to its last
    nonzero bin."""
    first, offset, weights = [], [0], []
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first.append(lo)
        weights.append(fb[lo:hi, m].astype(np.float64))
        offset.append(offset[-1] + hi - lo)
    return (np.asarray(first, np.int32), np.asarray(offset, np.int32),
            np.concatenate(weights))


def kernel_tables(cfg: AudioConfig):
    """K3's host tables, numpy: the window [n_fft] and the twiddles
    (``twiddles``), float64 made in float64; the filterbank's taps (first
    bin, offsets, weights: the f32 filterbank widened)."""
    first, offset, taps = filterbank_taps(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max))
    return dict(window=padded_window(cfg).astype(np.float64),
                twiddle=twiddles(cfg.n_fft), taps=taps, first=first,
                offset=offset)


@functools.lru_cache(maxsize=8)
def _kernel_constants(key, device: str):
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in kernel_tables(_cfg(key)).items()}


def log_mel_plain(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [B, N] f32 -> unnormalised log-mel [B, T, n_mels], step by step
    as the reference kernel: the plain version of K3."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    win, fb, cos, sin = _constants(_cfg_key(cfg), str(wav.device))
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
    check_geometry(cfg)
    lib = build.load("mel_frontend")
    c = _kernel_constants(_cfg_key(cfg), str(wav.device))
    out = torch.empty((B, 1 + N // cfg.hop_length, cfg.n_mels),
                      device=wav.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    with torch.cuda.device(wav.device):
        rc = lib.ttsx_mel_frontend_f32(
            wav.data_ptr(), c["window"].data_ptr(), c["twiddle"].data_ptr(),
            c["taps"].data_ptr(), c["first"].data_ptr(),
            c["offset"].data_ptr(), out.data_ptr(), B, N, cfg.n_fft,
            cfg.hop_length, cfg.n_mels, stream)
    build.check(rc, "ttsx_mel_frontend_f32")
    log_mel.launches += 1
    return out
