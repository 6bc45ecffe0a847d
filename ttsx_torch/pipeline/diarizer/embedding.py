"""Slice embedding extraction (``ttsx/pipeline/diarizer/embedding.py``).

Every slice is embedded in ONE batched call: the slice waveforms are
zero-padded to ``max_frames`` hops, go through one ``mel_spectrogram``
(the plain |rFFT| route of ``ttsx_torch.dsp.stft``, not the collator's
kernel K3, which floors silent frames differently) and one
``ReferenceEncoder`` call with the mask of each slice's frames, on
``device``. A handcrafted voiceprint (per-slice mean and std of the
unnormalized log-mel, centred across slices but not z-scored) is
appended with weight ``spec_weight`` (0.5 with trained ``params``, 2.0
without), then the optional cross-slice attention blend; those steps are
numpy on the host, as in the reference.

``params`` is the encoder's flax variables tree (numpy leaves), as the
reference takes it. Without it the encoder is a fresh flax-style init
drawn from ``torch.Generator().manual_seed(seed)``; the reference draws
from ``jax.random.PRNGKey(seed)``, so an untrained embedder differs from
the reference's (carry the reference's tree across as ``params`` to
compare the two).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig, RefEncConfig
from ttsx_torch.core.device import resolve_device


class SliceEmbedder:
    def __init__(self, au: AudioConfig | None = None,
                 cfg: RefEncConfig | None = None, params=None,
                 max_frames: int = 256, context_layers: int = 0,
                 spec_weight: float | None = None, seed: int = 0,
                 device="cuda"):
        # context_layers: cross-slice attention contextualization; off by
        # default (with an untrained encoder the softmax blend homogenizes
        # the embeddings)
        self.au = au or AudioConfig()
        self.cfg = cfg or RefEncConfig(speaker_dim=192, ecapa_channels=256)
        self.max_frames = max_frames
        self.context_layers = context_layers
        # the voiceprint must dominate an untrained encoder (which maps
        # everything near one direction) and yield to a trained one
        self.spec_weight = (spec_weight if spec_weight is not None
                            else (0.5 if params is not None else 2.0))
        self.device = resolve_device(device)
        self._params = params
        self._model = None
        self._seed = seed
        # diarize_batch shares one embedder across job threads: the lazy
        # build must be atomic (a half-built model seen by a second thread
        # would run with no weights)
        self._init_lock = threading.Lock()

    def _ensure_model(self):
        if self._model is not None:
            return
        with self._init_lock:
            if self._model is not None:
                return
            from ttsx_torch.models.reference_encoder import ReferenceEncoder
            # the encoder reads this embedder's mels (flax infers the
            # input width from them)
            cfg = dataclasses.replace(self.cfg, audio=dataclasses.replace(
                self.cfg.audio, n_mels=self.au.n_mels))
            model = ReferenceEncoder(cfg)
            if self._params is None:
                from ttsx_torch.nn.init import fresh_init_
                fresh_init_(model, torch.Generator().manual_seed(self._seed))
            else:
                from ttsx_torch.weights import load_flax
                load_flax(model, self._params)
            self._model = model.eval().to(self.device)

    def extract(self, wav: np.ndarray, slices: List[Tuple[float, float]]
                ) -> np.ndarray:
        """wav [N], slices [(s, e)...] -> embeddings [n_slices, D]."""
        from ttsx_torch.dsp.stft import mel_spectrogram

        if not slices:
            return np.zeros((0, self.cfg.speaker_dim), np.float32)
        sr = self.au.sample_rate
        hop = self.au.hop_length
        max_samples = self.max_frames * hop

        # ONE padded batch of slice waveforms -> ONE mel + encoder call
        batch = np.zeros((len(slices), max_samples), np.float32)
        mask_len = np.zeros(len(slices), np.int64)
        for i, (s, e) in enumerate(slices):
            seg = wav[int(s * sr):int(e * sr)][:max_samples]
            batch[i, :len(seg)] = seg
            mask_len[i] = max(len(seg) // hop, 1)

        self._ensure_model()
        x = torch.as_tensor(batch, device=self.device)
        with torch.inference_mode():
            mel = mel_spectrogram(x, self.au)          # [n, T, n_mels]
            T = mel.shape[1]
            mask_np = np.arange(T)[None, :] < mask_len[:, None]
            mask = torch.as_tensor(mask_np, device=self.device)
            emb = self._model(mel, mask).float().cpu().numpy()
            # the voiceprint reads the UNNORMALIZED log-mel: the per-bin
            # normalization would erase the spectral profile of the voice
            mel_raw = mel
            if self.au.mel_normalize:
                mel_raw = mel_spectrogram(
                    x, dataclasses.replace(self.au, mel_normalize=False))
            m = mel_raw.cpu().numpy().astype(np.float32)

        msk = mask_np.astype(np.float32)[..., None]
        denom = np.maximum(msk.sum(1), 1.0)
        mel_mean = (m * msk).sum(1) / denom                  # [n, n_mels]
        mel_std = np.sqrt(np.maximum(
            ((m - mel_mean[:, None]) ** 2 * msk).sum(1) / denom, 0.0))
        spec = np.concatenate([mel_mean, mel_std], axis=1)
        # centre per bin across slices, no variance equalization (a
        # per-bin std over a handful of slices amplifies noise-floor bins)
        spec = spec - spec.mean(0, keepdims=True)
        spec /= np.linalg.norm(spec, axis=1, keepdims=True) + 1e-8
        emb = np.concatenate([emb, self.spec_weight * spec], axis=1)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8

        # cross-slice contextualization: softmax(sim/temp) attention over
        # slices, residual, renormalize
        for _ in range(self.context_layers):
            sim = emb @ emb.T
            attn = np.exp(sim / 0.5 - sim.max(axis=1, keepdims=True) / 0.5)
            attn /= attn.sum(axis=1, keepdims=True)
            emb = emb + 0.5 * (attn @ emb)
            emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8
        return emb
