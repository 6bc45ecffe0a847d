"""The vocoder GAN's discriminators and STFT loss (``ttsx/models/vocoder.py``).

Each discriminator takes a waveform [B, T, 1] and returns (logits,
feature maps), one entry per sub-discriminator, in the reference's
layouts: a period discriminator's maps are [B, T//p, p, C] (T padded up
to a multiple of p), a scale or band discriminator's [B, T', C]. Inside,
the convolutions run channels-first, as torch's convs take them; the maps
handed back are channels-last views of their outputs (no copy).

* ``PeriodDiscriminator``: 4 spectral-normed (5, 1) convs of stride (3, 1)
  over the period image, channels x ``ch_growth`` each, then (3, 1) -> 1.
* ``ScaleDiscriminator``: 5 spectral-normed convs of strides 2, 2, 2, 1, 1,
  channels x ``ch_growth`` each, then k = 3 -> 1.
* ``BandDiscriminatorTower``: 4 spectral-normed convs k = 15, stride 2,
  then k = 3 -> 1.
* ``MultiPeriodDiscriminator`` (one per ``disc_periods``),
  ``MultiScaleDiscriminator`` (the wav, ``avg_pool1d(wav, 4, 2)`` and that
  pooled again, zipped with ``disc_kernel_sizes``) and
  ``MultiBandDiscriminator`` (``num_bands`` contiguous time chunks, T
  padded up to ``chunk * num_bands``). Submodules are named as in the
  reference's trees (``period_{p}``, ``scale_{i}``, ``band_{i}``,
  ``SNConv_{j}``), so ``weights.from_flax`` maps them one to one.
* ``STFTLoss``: per STFT size, the L1 between |STFT| x filterbank of the
  fake and the real wav, plus the L1 of their log magnitudes when
  ``stft_log_mag``, times ``lambda_stft``. The filterbank starts at ones
  and is frozen (a buffer): the reference creates its train state and
  never steps it.

Every activation is ``leaky_relu(0.2)``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ttsx_torch.core.config import VocoderConfig
from ttsx_torch.dsp.stft import stft_magnitude
from ttsx_torch.nn.conv import SNConv, avg_pool1d

Output = Tuple[torch.Tensor, List[torch.Tensor]]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _channels_last(h: torch.Tensor) -> torch.Tensor:
    return h.movedim(1, -1)


class _SNStack(nn.Module):
    """``n`` spectral-normed convs with leaky ReLU, channels x ``growth``
    each (from 1), then a last conv to 1 channel."""

    def __init__(self, n: int, growth: int, kernels, strides, last_kernel):
        super().__init__()
        self.n = n
        ch = 1
        for j in range(n):
            setattr(self, f"SNConv_{j}", SNConv(ch, ch * growth, kernels[j],
                                                strides[j]))
            ch *= growth
        setattr(self, f"SNConv_{n}", SNConv(ch, 1, last_kernel))

    def forward(self, h: torch.Tensor) -> Output:
        feats = []
        for j in range(self.n):
            h = _lrelu(getattr(self, f"SNConv_{j}")(h))
            feats.append(_channels_last(h))
        return _channels_last(getattr(self, f"SNConv_{self.n}")(h)), feats


class PeriodDiscriminator(_SNStack):
    def __init__(self, period: int, ch_growth: int = 4):
        super().__init__(4, ch_growth, [(5, 1)] * 4, [(3, 1)] * 4, (3, 1))
        self.period = period

    def forward(self, x: torch.Tensor) -> Output:
        B, T, _ = x.shape
        p = self.period
        pad = (-T) % p
        h = F.pad(x[..., 0], (0, pad)) if pad else x[..., 0]
        return super().forward(h.reshape(B, 1, (T + pad) // p, p))


class ScaleDiscriminator(_SNStack):
    def __init__(self, kernel_size: int, ch_growth: int = 4):
        super().__init__(5, ch_growth, [(kernel_size,)] * 5,
                         [(2,)] * 3 + [(1,)] * 2, (3,))

    def forward(self, x: torch.Tensor) -> Output:
        return super().forward(x.transpose(1, 2))


class BandDiscriminatorTower(_SNStack):
    def __init__(self, ch_growth: int = 4):
        super().__init__(4, ch_growth, [(15,)] * 4, [(2,)] * 4, (3,))

    def forward(self, x: torch.Tensor) -> Output:
        return super().forward(x.transpose(1, 2))


class _Multi(nn.Module):
    def _run(self, parts) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
        logits, features = [], []
        for disc, x in parts:
            l, f = disc(x)
            logits.append(l)
            features.append(f)
        return logits, features


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.periods = tuple(cfg.disc_periods)
        for p in self.periods:
            setattr(self, f"period_{p}",
                    PeriodDiscriminator(p, cfg.disc_ch_growth))

    def forward(self, wav: torch.Tensor):
        return self._run((getattr(self, f"period_{p}"), wav)
                         for p in self.periods)


class MultiScaleDiscriminator(_Multi):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.n = min(len(cfg.disc_kernel_sizes), 3)
        for i, ks in enumerate(cfg.disc_kernel_sizes[:self.n]):
            setattr(self, f"scale_{i}",
                    ScaleDiscriminator(ks, cfg.disc_ch_growth))

    def forward(self, wav: torch.Tensor):
        scales = [wav]
        for _ in range(self.n - 1):
            scales.append(avg_pool1d(scales[-1], 4, 2))
        return self._run((getattr(self, f"scale_{i}"), s)
                         for i, s in enumerate(scales))


class MultiBandDiscriminator(_Multi):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.nb = cfg.num_bands
        for i in range(self.nb):
            setattr(self, f"band_{i}",
                    BandDiscriminatorTower(cfg.disc_ch_growth))

    def forward(self, wav: torch.Tensor):
        nb = self.nb
        T = wav.shape[1]
        chunk = max(-(-T // nb), 1)
        pad = chunk * nb - T
        if pad:
            wav = F.pad(wav, (0, 0, 0, pad))
        return self._run((getattr(self, f"band_{i}"),
                          wav[:, i * chunk:(i + 1) * chunk])
                         for i in range(nb))


class LearnableSTFT(nn.Module):
    """One STFT size of the loss: ``magnitude`` (wav [B, T, 1] -> |STFT|
    [B, frames, n_fft//2 + 1]) and the ``filterbank`` that weights it."""

    def __init__(self, n_fft: int, hop_length: int):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.register_buffer("filterbank", torch.ones(n_fft // 2 + 1))

    def magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        return stft_magnitude(wav[..., 0], self.n_fft, self.hop_length)


class STFTLoss(nn.Module):
    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.sizes = tuple(cfg.stft_sizes)
        self.log_mag, self.lambda_stft = cfg.stft_log_mag, cfg.lambda_stft
        for n_fft in self.sizes:
            setattr(self, f"stft_{n_fft}", LearnableSTFT(n_fft,
                                                         cfg.hop_length))

    def forward(self, wav_fake: torch.Tensor, wav_real: torch.Tensor
                ) -> torch.Tensor:
        loss = 0.0
        for n_fft in self.sizes:
            st = getattr(self, f"stft_{n_fft}")
            mf, mr = st.magnitude(wav_fake), st.magnitude(wav_real)
            fb = st.filterbank
            loss = loss + (mf * fb - mr * fb).abs().mean()
            if self.log_mag:
                loss = loss + (torch.log(mf + 1e-5)
                               - torch.log(mr + 1e-5)).abs().mean()
        return loss * self.lambda_stft
