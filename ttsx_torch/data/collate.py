"""Batch collation (``ttsx/data/collate.py``): bucketed padding, seeded
wav augments, feature cache, SpecAugment, mixup, and the batched features.

The augments and SpecAugment are numpy on the host, as in the reference.
The features are computed in one batched call on ``device``: the log-mel
through the mel-frontend kernel K3 (``ttsx_torch.ops.mel_frontend``;
its plain version on the CPU) and f0 / energy
(``ttsx_torch.dsp.features``). The batch comes back as numpy.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.dsp.features import extract_f0_energy
from ttsx_torch.ops.mel_frontend import mel_frontend
from ttsx_torch.utils.spans import timed


def bucket_length(n: int, bucket: int = 4096) -> int:
    """Round up to a multiple of ``bucket`` (few distinct batch shapes)."""
    return int(np.ceil(max(n, 1) / bucket) * bucket)


def add_noise(wav: np.ndarray, rng: np.random.Generator,
              noise_bank: Optional[Sequence[np.ndarray]] = None,
              snr_db_range=(5.0, 20.0)) -> np.ndarray:
    """Additive noise at a random SNR; white noise without a bank."""
    snr_db = rng.uniform(*snr_db_range)
    if noise_bank:
        noise = noise_bank[rng.integers(len(noise_bank))]
        if len(noise) < len(wav):
            noise = np.tile(noise, int(np.ceil(len(wav) / len(noise))))
        start = rng.integers(0, len(noise) - len(wav) + 1)
        noise = noise[start:start + len(wav)]
    else:
        noise = rng.normal(size=len(wav)).astype(np.float32)
    p_sig = np.mean(wav ** 2) + 1e-10
    p_noise = np.mean(noise ** 2) + 1e-10
    scale = np.sqrt(p_sig / (p_noise * 10 ** (snr_db / 10.0)))
    return wav + scale * noise


def add_reverb(wav: np.ndarray, rng: np.random.Generator,
               rir_bank: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
    """Convolution with a room impulse response (a synthetic exponential
    decay without a bank), peak-matched to the input."""
    if rir_bank:
        rir = rir_bank[rng.integers(len(rir_bank))]
    else:
        n = 2000
        rir = (rng.normal(size=n) * np.exp(-np.linspace(0, 8, n))).astype(
            np.float32)
        rir[0] = 1.0
    out = np.convolve(wav, rir)[:len(wav)].astype(np.float32)
    peak = np.abs(out).max() + 1e-8
    return out / peak * (np.abs(wav).max() + 1e-8)


def speed_perturb(wav: np.ndarray, rng: np.random.Generator,
                  factors=(0.9, 1.1)) -> np.ndarray:
    """Speed change by linear resampling."""
    f = factors[rng.integers(len(factors))]
    n = int(round(len(wav) / f))
    return np.interp(np.linspace(0, len(wav) - 1, n), np.arange(len(wav)),
                     wav).astype(np.float32)


def load_noise_bank(directory, target_sr: int, limit: int = 64
                    ) -> List[np.ndarray]:
    """The first ``limit`` wavs under ``directory`` (sorted, recursive) at
    ``target_sr``, empty ones left out: a bank of noises for the
    augments."""
    from pathlib import Path
    from ttsx_torch.data.dataset import read_wav
    bank = []
    for p in sorted(Path(directory).glob("**/*.wav"))[:limit]:
        wav, _ = read_wav(p, target_sr)
        if len(wav):
            bank.append(wav)
    return bank


class AugmentationPipeline:
    """The augments in a random order, each applied with probability p."""

    def __init__(self, augments: Optional[List[Callable]] = None,
                 p: float = 0.5):
        self.augments = augments if augments is not None else [
            add_noise, add_reverb, speed_perturb]
        self.p = p

    def __call__(self, wav: np.ndarray, rng: np.random.Generator
                 ) -> np.ndarray:
        for i in rng.permutation(len(self.augments)):
            if rng.random() < self.p:
                wav = self.augments[i](wav, rng)
        return wav


def spec_augment(mel: np.ndarray, rng: np.random.Generator,
                 freq_mask: int = 15, time_mask: int = 35,
                 n_masks: int = 1) -> np.ndarray:
    """One frequency and one time mask per item on [B, T, n_mels]."""
    mel = mel.copy()
    B, T, F = mel.shape
    for b in range(B):
        for _ in range(n_masks):
            f = rng.integers(0, freq_mask + 1)
            f0 = rng.integers(0, max(F - f, 1))
            mel[b, :, f0:f0 + f] = 0.0
            t = rng.integers(0, min(time_mask, T) + 1)
            t0 = rng.integers(0, max(T - t, 1))
            mel[b, t0:t0 + t, :] = 0.0
    return mel


def mixup(mel: np.ndarray, labels: np.ndarray, rng: np.random.Generator,
          alpha: float = 0.4):
    """Beta(alpha, alpha) mixup of a batch with a permutation of itself:
    (mixed mel, labels, permuted labels, lambda)."""
    lam = rng.beta(alpha, alpha)
    perm = rng.permutation(len(mel))
    mixed = lam * mel + (1 - lam) * mel[perm]
    return mixed.astype(mel.dtype), labels, labels[perm], lam


@dataclass
class CollatorConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    augment: bool = True
    spec_augment: bool = True
    cache_features: bool = True
    bucket_wav: int = 8192
    bucket_text: int = 64
    seed: int = 0
    half: bool = False  # float outputs as float16


class TTSCollator:
    """List of ``TTSDataset`` items -> padded batch dict of numpy arrays.

    ``mel_fn`` / ``f0_fn`` take the padded wav batch as a tensor on
    ``device`` and default to K3 (``mel_frontend``) and
    ``extract_f0_energy`` there."""

    def __init__(self, cfg: CollatorConfig,
                 augmenter: Optional[AugmentationPipeline] = None,
                 mel_fn: Optional[Callable] = None,
                 f0_fn: Optional[Callable] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.augmenter = augmenter or AugmentationPipeline()
        self._cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self.mel_fn = mel_fn or (lambda w: mel_frontend(w, cfg.audio))
        self.f0_fn = f0_fn or (lambda w: extract_f0_energy(w, cfg.audio))

    def _augmented_wav(self, item: Dict, rng: np.random.Generator
                       ) -> np.ndarray:
        key = item.get("wav_path")
        if self.cfg.cache_features and key:
            with self._lock:
                if key in self._cache:
                    return self._cache[key]
        wav = item["wav"]
        if self.cfg.augment:
            wav = self.augmenter(wav, rng)
        if self.cfg.cache_features and key:
            with self._lock:
                self._cache[key] = wav
        return wav

    def _rng(self, epoch: int, batch_idx: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + epoch * 10_007 + batch_idx)
            & 0x7FFFFFFF)

    def cached(self, wav_path: str) -> bool:
        with self._lock:
            return wav_path in self._cache

    def replay(self, items: List[Dict], epoch: int = 0,
               batch_idx: int = 0) -> None:
        """Fill the feature cache as ``__call__`` on this batch would,
        without computing its features: a stream that skips batches
        (a resumed run) replays them, so that every wav keeps the
        augmentation of the batch it first came in. Items whose wav is
        cached already may be left out: they draw nothing."""
        rng = self._rng(epoch, batch_idx)
        for it in items:
            self._augmented_wav(it, rng)

    def __call__(self, items: List[Dict], epoch: int = 0,
                 batch_idx: int = 0) -> Dict:
        """The batch, with ``collate_time``: the host seconds of its
        ``collate`` span (``ttsx_torch.utils.spans.timed``)."""
        with timed("collate") as t:
            out = self._collate(items, epoch, batch_idx)
        out["collate_time"] = t.seconds
        return out

    def _collate(self, items: List[Dict], epoch: int, batch_idx: int
                 ) -> Dict:
        rng = self._rng(epoch, batch_idx)

        wavs = [self._augmented_wav(it, rng) for it in items]
        max_wav = bucket_length(max(len(w) for w in wavs),
                                self.cfg.bucket_wav)
        wav_batch = np.zeros((len(items), max_wav), np.float32)
        wav_lengths = np.zeros(len(items), np.int32)
        for i, w in enumerate(wavs):
            wav_batch[i, :len(w)] = w
            wav_lengths[i] = len(w)

        # one batched feature call on the device
        wav_dev = torch.as_tensor(wav_batch, device=self.device)
        mel = self.mel_fn(wav_dev).cpu().numpy()
        f0, energy, _ = (x.cpu().numpy() for x in self.f0_fn(wav_dev))
        T = mel.shape[1]
        frame_lengths = np.minimum(
            wav_lengths // self.cfg.audio.hop_length + 1, T).astype(np.int32)
        frame_mask = np.arange(T)[None, :] < frame_lengths[:, None]

        if self.cfg.spec_augment and self.cfg.augment:
            mel = spec_augment(mel, rng)

        max_text = bucket_length(max(it["text_length"] for it in items),
                                 self.cfg.bucket_text)
        text_ids = np.zeros((len(items), max_text), np.int32)
        text_mask = np.zeros((len(items), max_text), bool)
        for i, it in enumerate(items):
            n = it["text_length"]
            text_ids[i, :n] = it["text_ids"]
            text_mask[i, :n] = True

        ftype = np.float16 if self.cfg.half else np.float32
        ids = lambda key: np.asarray([it[key] for it in items], np.int32)
        return {
            "wav": wav_batch[..., None].astype(ftype),
            "wav_length": wav_lengths,
            "mel": np.asarray(mel, ftype),
            "f0": np.asarray(f0, ftype),
            "energy": np.asarray(energy, ftype),
            "frame_length": frame_lengths,
            "frame_mask": frame_mask,
            "text_ids": text_ids,
            "text_mask": text_mask,
            "text_length": ids("text_length"),
            "text_emb": np.stack([it["text_emb"] for it in items]
                                 ).astype(ftype),
            "speaker_id": ids("speaker_id"),
            "domain_id": ids("domain_id"),
            "style_id": ids("style_id"),
            "transcripts": [it["transcript"] for it in items],
        }
