"""Formant (source-filter) synthetic-speech corpus
(``ttsx/data/formantcorpus.py``).

Where ``ToneCorpus`` is additive narrowband harmonics, this corpus makes
speech-shaped audio the Klatt way: a glottal-like harmonic series
(-12 dB/oct) plus aspiration noise, through parallel formant resonators
that follow per-"phoneme" F1-F3 targets (smoothed frame tracks for
coarticulation), applied by frame overlap-add. A speaker is a
vocal-tract length scale on every formant, a bandwidth and a base f0
(shareable across speakers with ``n_f0_groups``, so that pitch alone
does not name the speaker); ``speaker_cues="rich"`` adds breathiness,
spectral tilt and vibrato per speaker, ``"vtl"`` keeps them fixed.

Everything is numpy from the seed, the reference's draws in the
reference's order, so one seed gives the same arrays in both packages.
It keeps ``ToneCorpus``'s interface (``utterances``, ``features`` on a
device, ``dialogue``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.data.tonecorpus import ToneCorpus, Utterance, _smooth_random


class FormantCorpus(ToneCorpus):
    """Deterministic source-filter corpus: speakers x phonemes."""

    N_FORMANTS = 3

    def __init__(self, n_speakers: int = 12, n_phonemes: int = 24,
                 text_dim: int = 256, audio: Optional[AudioConfig] = None,
                 seed: int = 0, n_f0_groups: Optional[int] = None,
                 noise_db: Optional[float] = None,
                 intonation: float = 0.0, speaker_cues: str = "vtl"):
        super().__init__(n_speakers=n_speakers, n_phonemes=n_phonemes,
                         text_dim=text_dim, audio=audio, seed=seed,
                         n_f0_groups=n_f0_groups, noise_db=noise_db,
                         intonation=intonation)
        rng = np.random.default_rng(seed + 101)
        # vocal-tract length scale: shifts ALL formants of a speaker;
        # the primary learnable timbre cue (f0 may be group-shared)
        self.spk_vtl = rng.uniform(0.82, 1.25, n_speakers)
        self.spk_bw = rng.uniform(60.0, 110.0, n_speakers)   # Hz, base
        # speaker_cues="rich": additional stationary per-speaker traits
        # (the VERDICT r2 #8 contingency — VTL-only identity caps the
        # learnable EER; real speakers also differ in voice quality).
        # "vtl" keeps the round-2 corpus bit-identical.
        if speaker_cues == "rich":
            self.spk_breath_mul = rng.uniform(0.4, 2.2, n_speakers)
            self.spk_tilt = rng.uniform(0.80, 1.25, n_speakers)
            self.spk_vib_rate = rng.uniform(4.3, 6.7, n_speakers)
            self.spk_vib_depth = rng.uniform(0.001, 0.006, n_speakers)
        elif speaker_cues == "vtl":
            self.spk_breath_mul = np.ones(n_speakers)
            self.spk_tilt = np.ones(n_speakers)
            self.spk_vib_rate = np.full(n_speakers, 5.5)
            self.spk_vib_depth = np.full(n_speakers, 0.003)
        else:
            raise ValueError(f"speaker_cues must be 'vtl' or 'rich', "
                             f"got {speaker_cues!r}")
        # per-phoneme formant targets (vowel-space ranges, F2 > F1)
        f1 = rng.uniform(260.0, 860.0, n_phonemes)
        f2 = np.maximum(rng.uniform(850.0, 2400.0, n_phonemes),
                        f1 + 300.0)
        f3 = rng.uniform(2300.0, 3100.0, n_phonemes)
        self.pho_formants = np.stack([f1, f2, f3], axis=1)   # [P, K]
        # relative formant amplitudes (parallel branch gains) + breathiness
        self.pho_gain = np.stack(
            [_smooth_random(rng, self.N_FORMANTS, smooth=1,
                            lo=0.35, hi=1.0) for _ in range(n_phonemes)])
        self.pho_breath = rng.uniform(0.02, 0.15, n_phonemes)

    # -- synthesis ---------------------------------------------------------
    def utterance(self, speaker: int, frames: int,
                  rng: np.random.Generator) -> Utterance:
        au = self.audio
        hop, sr = au.hop_length, au.sample_rate
        win = au.win_length
        # frame-aligned phoneme sequence, 6-14 frame segments
        ids = np.empty(frames, np.int32)
        t0 = 0
        while t0 < frames:
            dur = int(rng.integers(6, 15))
            ids[t0:t0 + dur] = rng.integers(0, self.n_phonemes)
            t0 += dur
        n = frames * hop
        frame_of = np.minimum(np.arange(n) // hop, frames - 1)

        # ---- source: f0 contour -> band-limited -12 dB/oct harmonics
        f0 = float(self.spk_f0[speaker])
        decl = np.linspace(1.05, 0.92, frames)          # declination
        contour = decl.copy()
        if self.intonation > 0.0:
            w = 9
            raw = rng.uniform(-self.intonation, self.intonation,
                              frames + w - 1)
            contour = contour * (
                1.0 + np.convolve(raw, np.ones(w) / w, mode="valid"))
        t = np.arange(n) / sr
        vib = 1.0 + self.spk_vib_depth[speaker] * np.sin(
            2 * np.pi * self.spk_vib_rate[speaker] * t
            + rng.uniform(0, 2 * np.pi))
        f0_t = f0 * contour[frame_of] * vib             # [n]
        phi = 2 * np.pi * np.cumsum(f0_t) / sr
        n_harm = int(0.45 * sr / (f0_t.min() + 1e-6))
        h = np.arange(1, n_harm + 1)
        # sawtooth series (1/h == -6 dB/oct) x 1/sqrt(h) extra rolloff
        # ~= glottal -9..-12 dB/oct; per-sample Nyquist guard for glides.
        # spk_tilt: per-speaker spectral-tilt exponent ("rich" cue)
        amp_h = 1.0 / (h * np.sqrt(h)) ** self.spk_tilt[speaker]
        alive = (h[None, :] * f0_t[:, None]) < (0.45 * sr)
        exc = (np.sin(phi[:, None] * h[None, :])
               * (amp_h[None, :] * alive)).sum(axis=1)
        # aspiration noise, per-phoneme breathiness, pre-filter so it
        # picks up the same formant structure
        breath = (self.pho_breath[ids[frame_of]]
                  * self.spk_breath_mul[speaker])
        exc = exc + rng.normal(size=n) * breath * np.std(exc)

        # ---- filter: frame-OLA magnitude filtering by formant resonators
        K = self.N_FORMANTS
        vtl, bw = self.spk_vtl[speaker], self.spk_bw[speaker]
        targets = self.pho_formants[ids] * vtl          # [frames, K]
        gains = self.pho_gain[ids]                      # [frames, K]
        # coarticulation: moving-average smoothing of the target tracks
        k5 = np.ones(5) / 5.0
        tracks = np.stack(
            [np.convolve(np.pad(targets[:, k], 2, mode="edge"), k5,
                         mode="valid") for k in range(K)], axis=1)
        gtr = np.stack(
            [np.convolve(np.pad(gains[:, k], 2, mode="edge"), k5,
                         mode="valid") for k in range(K)], axis=1)
        # frame the excitation (centered windows, edge-padded)
        pad = win // 2
        exc_p = np.pad(exc, (pad, pad))
        idx = np.arange(win)[None, :] + hop * np.arange(frames)[:, None]
        fr = exc_p[idx] * np.hanning(win)[None, :]      # [frames, win]
        spec = np.fft.rfft(fr, axis=1)                  # [frames, F]
        freqs = np.fft.rfftfreq(win, d=1.0 / sr)        # [F]
        bws = bw * (1.0 + 0.4 * np.arange(K))           # wider high formants
        # parallel resonator magnitudes, each normalized to peak ~1
        f2_ = freqs[None, None, :] ** 2                 # [1, 1, F]
        Fk2 = tracks[:, :, None] ** 2                   # [frames, K, 1]
        num = tracks[:, :, None] * bws[None, :, None]
        g = num / np.sqrt((f2_ - Fk2) ** 2
                          + (bws[None, :, None] * freqs[None, None, :]) ** 2
                          + 1e-12)
        G = (gtr[:, :, None] * g).sum(axis=1)           # [frames, F]
        y = np.fft.irfft(spec * G, n=win, axis=1) * np.hanning(win)[None, :]
        # hann^2 at 75% overlap sums to a constant 1.5
        wav = np.zeros(n + 2 * pad)
        np.add.at(wav, idx, y)
        wav = wav[pad:-pad] / 1.5
        wav = 0.3 * wav / (np.abs(wav).max() + 1e-8)
        if self.noise_db is not None:
            snr = 10.0 ** (self.noise_db / 20.0)
            wav = wav + rng.normal(size=n) * (np.std(wav) / snr)
        return Utterance(wav.astype(np.float32), ids, speaker, f0)
